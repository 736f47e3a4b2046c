"""The training cell: steps of the port's trainer, and what decides their
`correct`.

Set-up builds one training state from the seed (the network's weights
drawn on the device: tables uniform in +-1e-4, the MLP He-normal, as the
trainer initialises them) and one generator for the sampler's rays, and
drives that state through its first three steps with the window's own
call (`train/trainer.py::make_train_step`: sample, then gradient and
AdamW). The window then goes on with the same state and generator. The
reference follows those three steps from the same weights and the same
draws (a generator seeded alike on the same device) and is compared on:
  loss_gap     the worst step's |loss - reference loss| / reference loss;
  grad_gap     the worst leaf's gap between the norm of the first
               gradient as AdamW holds it after step 1 (exp_avg / (1 - b1))
               and the reference's, over the larger of the reference
               leaf's norm and the median leaf's;
  change_gap   the same of the parameters' change over the three steps,
               over the leaves whose reference gradient is not nought to
               rounding (at least 1e-3 of the median leaf's).
"""

from __future__ import annotations

import math

import numpy as np

B1 = 0.9
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
# The steps the reference follows.
STEPS = 3


def _seeds(seed: int) -> tuple[int, int]:
    """(weights' seed, rays' seed) of a run's seed."""
    s = int(seed) % (1 << 62)
    return 2 * s, 2 * s + 1


def initial_weights(seed: int, sublanes: int, pack: int, device):
    """[lane, mlp_0 .. mlp_4] drawn on the device from the seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(_seeds(seed)[0])
    shape = (3, 8, 4, sublanes) + ((pack,) if pack == 2 else ()) + (128,)
    lane = torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device) * 2e-4 - 1e-4
    dims = [112, 128, 128, 128, 128, 16]
    mlp = [torch.randn((o, i), generator=gen, dtype=torch.float32,
                       device=device) * math.sqrt(2.0 / i)
           for i, o in zip(dims[:-1], dims[1:])]
    return [lane] + mlp


class TrainCell:
    """Training steps of `batch` segments (`segments_per_ray` per ray),
    AdamW at `learning_rate` / `weight_decay` under the cosine schedule
    over `schedule_steps`; a call is one step and returns its loss (read
    on the host, so the step has ended on the device)."""

    def __init__(self, config_path: str, traffic: dict, seed: int, device,
                 program: bool = True):
        import json
        self.traffic = traffic
        self.batch = int(traffic["batch"])
        self.segments = int(traffic["segments_per_ray"])
        with open(config_path) as f:
            nn = json.load(f)["neural_network"]
        self.sublanes = int(nn["lane_sublanes"])
        self.pack = int(nn.get("lane_entry_pack", 2))
        self.base_resolution = int(nn["base_resolution"])
        self.seed = seed
        self.init = [w.detach().clone() for w in initial_weights(
            seed, self.sublanes, self.pack, device)]
        self.calls = 0
        self.losses, self.grad1, self.params3 = [], None, None
        self.state = None
        if program:
            self._build(config_path, device)

    def _build(self, config_path: str, device):
        import torch

        from neural_renderer_tpu_torch import config as nr_config
        from neural_renderer_tpu_torch.models import nbvh
        from neural_renderer_tpu_torch.scene.scene import Scene
        from neural_renderer_tpu_torch.train import trainer
        t = self.traffic
        cfg = nr_config.load_config(config_path)
        scene = Scene.from_config(cfg)
        net_config = nbvh.NbvhConfig.from_network_config(cfg.neural_network)
        net = nbvh.ShellNetwork(net_config,
                                [w.clone() for w in self.init[1:]],
                                lane=self.init[0].clone())
        net.requires_grad_(True)
        tcfg = trainer.TrainConfig(
            batch_size=self.batch, learning_rate=t["learning_rate"],
            weight_decay=t["weight_decay"], steps=t["schedule_steps"],
            lr_schedule="cosine", lr_end_factor=t["lr_end_factor"],
            segments_per_ray=self.segments)
        opt, sched = trainer.make_optimizer(tcfg, net.parameters())
        self.state = trainer.TrainState(net, opt, sched, 0)
        meshes = [getattr(scene, m).to_tensors(device) for m in
                  ("original_mesh", "outer_shell", "inner_shell")]
        omin, inv, radius = trainer.segment_domain(scene, device)
        self.step = trainer.make_train_step(
            tcfg, net_config, *meshes, omin, inv, radius,
            global_row=trainer.scene_global_row(scene, device),
            device=device)
        self.gen = torch.Generator(device=device).manual_seed(
            _seeds(self.seed)[1])

    @property
    def work_per_call(self) -> int:
        return self.batch

    def call(self):
        import torch
        _, metrics = self.step(self.state, self.gen)
        loss = float(metrics["total"])
        self.calls += 1
        if self.calls <= STEPS:
            self.losses.append(loss)
            params = list(self.state.net.parameters())
            if self.calls == 1:
                # exp_avg = (1 - b1) g after one step (zeros where the
                # optimizer kept no state).
                state = self.state.optimizer.state
                self.grad1 = [
                    state[p]["exp_avg"].detach() / (1.0 - B1)
                    if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                    for p in params]
            if self.calls == STEPS:
                self.params3 = [p.detach().clone() for p in params]
        return loss

    def plan_check(self, spec: dict, seed: int):
        if int(self.traffic["warmup_calls"]) < STEPS:
            raise ValueError(f"a training cell warms up with at least "
                             f"{STEPS} steps, the steps it compares")

    def keep(self, i: int, out):
        pass

    def close(self):
        self.state = self.step = self.gen = None

    def check(self, config_path: str, spec: dict, device) -> dict:
        """Free the program, then follow its first steps with the
        reference."""
        import gc

        import torch
        program = {"losses": self.losses,
                   "grad1": [float(torch.linalg.vector_norm(g))
                             for g in self.grad1],
                   "change": [float(torch.linalg.vector_norm(p - p0))
                              for p, p0 in zip(self.params3, self.init)]}
        self.grad1 = self.params3 = None
        self.close()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        self.check_note = f"{STEPS} steps of {self.batch} segments"
        return compare(program, reference_steps(config_path, self, device))


def reference_steps(config_path: str, cell: TrainCell, device,
                    precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's first steps from the cell's weights and draws:
    {"losses", "grad1" (norms), "change" (norms)}. `fault` plants one of
    the faults the check has to catch: "half" (every other row left out,
    the loss the mean over the rest) or "altered" (every tenth row's
    presence target flipped where the batch is made)."""
    import torch

    from reference.frame import Scene
    from reference.network import Network
    from reference.train import AdamW, cosine_lr, loss, sample_batch
    t = cell.traffic
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        scene = Scene.from_file(config_path, device, neural=False)
        params = [w.clone().requires_grad_(True) for w in cell.init]
        net = Network(params[0], params[1:], cell.base_resolution, 2.0,
                      precision)
        opt = AdamW(params, cosine_lr(t["learning_rate"],
                                      t["schedule_steps"],
                                      t["lr_end_factor"]),
                    t["weight_decay"])
        gen = torch.Generator(device=device).manual_seed(
            _seeds(cell.seed)[1])
        radius = 1.5 * float(np.linalg.norm(scene.outer.bmax
                                            - scene.outer.bmin))
        losses, grad1 = [], None
        for step in range(STEPS):
            with torch.no_grad():
                b = sample_batch(scene, gen, cell.batch, cell.segments,
                                 radius)
                rows = torch.arange(cell.batch, device=b.valid.device)
                if fault == "half":
                    b = b._replace(valid=b.valid & (rows % 2 == 0))
                elif fault == "altered":
                    flip = (rows % 10 == 0).to(torch.float32)
                    b = b._replace(presence=b.presence * (1 - flip)
                                   + (1 - b.presence) * flip)
            total = loss(net(b.inputs), b)
            grads = torch.autograd.grad(total, params)
            losses.append(float(total.detach()))
            if step == 0:
                grad1 = [float(torch.linalg.vector_norm(g)) for g in grads]
            opt.step(grads)
        change = [float(torch.linalg.vector_norm(p.detach() - p0))
                  for p, p0 in zip(params, cell.init)]
        return {"losses": losses, "grad1": grad1, "change": change}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def compare(program: dict, reference: dict) -> dict:
    """The numbers of NUMBERS from the program's and the reference's
    losses and leaf norms."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                      reference["losses"]))
    g_ref = np.asarray(reference["grad1"])
    g_med = float(np.median(g_ref))
    grad_gap = max(abs(p - r) / max(r, g_med)
                   for p, r in zip(program["grad1"], g_ref))
    c_ref = np.asarray(reference["change"])
    c_med = float(np.median(c_ref))
    counted = [i for i, g in enumerate(g_ref) if g >= 1e-3 * g_med]
    change_gap = max(abs(program["change"][i] - c_ref[i])
                     / max(c_ref[i], c_med) for i in counted)
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "change_gap": float(change_gap)}


def control_numbers(config_path: str, traffic: dict, spec: dict, seed: int,
                    device, fault: str | None = None) -> dict:
    """The control: the reference with its network in float8 e4m3 (tables,
    weights and layer inputs; the port trains with bf16 operands) in the
    program's place, against the reference; with `fault`, the reference
    with that fault planted in the program's place instead."""
    cell = TrainCell(config_path, traffic, seed, device, program=False)
    if fault is None:
        low = reference_steps(config_path, cell, device, precision="fp8")
    else:
        low = reference_steps(config_path, cell, device, fault=fault)
    return compare(low, reference_steps(config_path, cell, device))
