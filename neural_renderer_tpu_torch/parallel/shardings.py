"""Multi-GPU parallelism: pixel-stripe rendering and dp/tp training.

Port of `neural_renderer_tpu/parallel/shardings.py`, the same nine names,
on `torch.distributed` with one process per rank (parallel/launch.py spawns
them) where the JAX package runs one process over a device mesh:

  * `make_mesh`: a `DeviceMesh` of the process group's ranks with dims
    ("dp", "tp").
  * Rendering: each rank of the "dp" axis renders rows [r*H/dp,
    (r+1)*H/dp) with GLOBAL pixel ids (the RNG streams of the whole frame)
    and keeps its stripe of the accumulation (the shard of JAX's
    row-sharded array); `all_gather` assembles the u8 image (the
    all-gather XLA inserts). Meshes and network are replicated.
    `bilateral_denoise_tiled` exchanges one [10, R, W] halo message in
    each direction (`batch_isend_irecv`) and gathers only its image;
    `psnr_tiled` reduces float64 sums of squared error.
  * Training: `shard_train_state` keeps each rank's 1/tp share of every
    parameter and of its AdamW moments, on the axes of `shard_params_spec`
    (the JAX package's); a step gathers the whole tensors for the forward
    and backward, reduce-scatters the gradients over "tp", sums them over
    "dp" and updates the rank's shard. The batch's rows are split over
    every rank (dp slices, each cut again over its tp group, so no rank
    repeats another's rows), and the loss divides by the global counts of
    valid and present segments, so a step equals the unsharded step up to
    the order of the f32 sums.

Under gloo the collectives take CPU tensors: CUDA tensors are staged
through host memory (`_staged`), and the compute stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..render import pathtrace

AXES = ("dp", "tp")


# ---------------------------------------------------------------------------
# Mesh and collectives
# ---------------------------------------------------------------------------

def make_mesh(dp: int | None = None, tp: int = 1, axis_names=AXES):
    """A (dp, tp) DeviceMesh over the ranks of the initialised process
    group; dp defaults to world // tp, and dp * tp must be the world."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.spawn starts one per rank)")
    world = dist.get_world_size()
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the "
                         f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=tuple(axis_names))


def axis_coords(mesh, axis) -> tuple[int, int]:
    """(this rank's index, extent) along `axis`, a dim name or a tuple of
    them (flattened row-major)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    index, size = 0, 1
    for name in names:
        n = mesh[name].size()
        index = index * n + mesh.get_local_rank(name)
        size *= n
    return index, size


def _group(mesh, axis):
    return mesh.get_group(axis)


def _staged(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def all_gather_cat(t, group, dim: int):
    """The group's tensors, all of t's shape, concatenated along dim in
    group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    stage = _staged(t, group)
    src = t.detach().cpu() if stage else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if stage else out


def all_reduce_sum(t, group=None):
    """The sum of t over the group (a new tensor)."""
    stage = _staged(t, group)
    x = t.detach().cpu().clone() if stage else t.detach().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device) if stage else x


def reduce_scatter_sum(t, group, dim: int):
    """This rank's chunk along dim of the sum of t over the group."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.detach().clone()
    r = dist.get_rank(group)
    if _staged(t, group) or dist.get_backend(group) != "nccl":
        return all_reduce_sum(t, group).chunk(n, dim)[r].contiguous()
    chunks = [c.contiguous() for c in t.detach().chunk(n, dim)]
    out = torch.empty_like(chunks[r])
    dist.reduce_scatter(out, chunks, group=group)
    return out


# ---------------------------------------------------------------------------
# Pixel-stripe rendering
# ---------------------------------------------------------------------------

def stripe_rows(mesh, height: int, axis: str = "dp") -> tuple[int, int]:
    """(row0, rows) of this rank's stripe of a `height`-row frame."""
    index, n = axis_coords(mesh, axis)
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} stripes")
    rows = height // n
    return index * rows, rows


def tile_frame(frame, params, accum, mesh, axis="dp"):
    """Run `frame(accum, row0, rows)` on this rank's stripe of rows and
    gather its image over `axis`. accum: this rank's stripe of the
    accumulation [3, rows*W]; the accumulation and the guides the frame
    returns stay the rank's stripe."""
    row0, rows = stripe_rows(mesh, params.height, axis)
    if accum.shape[-1] != rows * params.width:
        raise ValueError(f"accumulation of {accum.shape[-1]} pixels is not "
                         f"a stripe of {rows} x {params.width}")
    out = frame(accum, row0, rows)
    return (all_gather_cat(out[0], _group(mesh, axis), 0), *out[1:])


def render_gt_frame_tiled(mesh_tensors, env, params, accum, mesh,
                          axis: str = "dp", return_guides: bool = False):
    """The ground-truth frame with pixel rows split over `axis`. accum:
    this rank's stripe [3, H/dp*W] of the accumulation (the shard of the
    JAX package's row-sharded array). Returns (image_u8 [H, W, 3] on every
    rank, the rank's new accumulation stripe), and with return_guides the
    rank's stripe of the guide buffers (normals, albedo) [3, H/dp, W]."""
    return tile_frame(
        lambda acc, row0, rows: pathtrace.render_gt_frame(
            mesh_tensors, env, params, acc, return_guides=return_guides,
            row0=row0, n_rows=rows),
        params, accum, mesh, axis)


def render_neural_frame_tiled(ctx, env, params, accum, mesh,
                              axis: str = "dp",
                              use_additional: bool = False,
                              additional_mesh=None,
                              return_guides: bool = False):
    """The neural frame (shell march and bounces) with pixel rows split
    over `axis`, as render_gt_frame_tiled; with global pixel ids each
    stripe equals its rows of the single-device frame."""
    from ..render.neural_frame import render_neural_frame
    return tile_frame(
        lambda acc, row0, rows: render_neural_frame(
            ctx, env, params, acc, use_additional=use_additional,
            additional_mesh=additional_mesh, return_guides=return_guides,
            row0=row0, n_rows=rows),
        params, accum, mesh, axis)


def stripe_stack(accum_rows, accum_count, normals, albedo):
    """The [10, rows, W] planes one stripe exchanges: colour (the
    accumulation over max(1, count), as bilateral_denoise takes it),
    normals, albedo and a valid plane of ones."""
    count = torch.as_tensor(accum_count, dtype=torch.float32,
                            device=accum_rows.device)
    color = accum_rows * (1.0 / torch.clamp(count, min=1.0))
    valid = torch.ones((1, *color.shape[1:]), dtype=color.dtype,
                       device=color.device)
    return torch.cat([color, normals, albedo, valid], dim=0)


def denoise_ext(ext, rows: int, width: int):
    """The u8 [rows, W, 3] stripe of a [10, rows + 2R, W] stack with its
    halos (zero rows with valid 0 beyond the frame)."""
    from ..ops.denoise import DENOISE_RADIUS as R
    from ..ops.denoise import _bilateral_core
    from ..ops.srgb import encode_srgb_u8
    ext = torch.nn.functional.pad(ext, (R, R))
    out = _bilateral_core(ext[0:3], ext[3:6], ext[6:9], ext[9], rows, width)
    return encode_srgb_u8(out).permute(1, 2, 0).contiguous()


def bilateral_denoise_tiled(accum, accum_count, guide_normals, guide_albedo,
                            mesh, axis: str = "dp"):
    """The joint bilateral denoiser with pixel rows split over `axis`.
    accum and the guides: this rank's stripes [3, H/dp, W], as the tiled
    frames return them. The 11x11 stencil needs R = 5 rows above and below
    a stripe: each rank sends its first and last R rows of colour,
    normals, albedo and a valid plane as one [10, R, W] message in each
    direction; the edge ranks' missing neighbours are zeros with valid 0,
    the whole frame's border. Only the denoised u8 image is gathered:
    returns it [H, W, 3] on every rank."""
    from ..ops.denoise import DENOISE_RADIUS as R
    _, rows, w = accum.shape
    if rows < R:
        raise ValueError(f"stripe rows {rows} < stencil radius {R}")
    group = _group(mesh, axis)
    stack = stripe_stack(accum, accum_count, guide_normals, guide_albedo)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    stage = _staged(stack, group)
    local = stack.cpu() if stage else stack
    halo_up = torch.zeros_like(local[:, :R])
    halo_dn = torch.zeros_like(local[:, :R])
    ops = []
    if r + 1 < n:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, local[:, -R:].contiguous(), peer,
                           group=group),
                dist.P2POp(dist.irecv, halo_dn, peer, group=group)]
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, local[:, :R].contiguous(), peer,
                           group=group),
                dist.P2POp(dist.irecv, halo_up, peer, group=group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    ext = torch.cat([halo_up.to(stack.device), stack,
                     halo_dn.to(stack.device)], dim=1)
    return all_gather_cat(denoise_ext(ext, rows, w), group, 0)


def psnr_tiled(ref_u8, test_u8, mesh, axis: str = "dp"):
    """PSNR of two whole u8 images [H, W, 3], each rank summing its
    stripe's squared error in float64 and `all_reduce` adding the sums.
    Returns a float64 scalar tensor (100 for identical images)."""
    h, w = ref_u8.shape[:2]
    row0, rows = stripe_rows(mesh, h, axis)
    d = (ref_u8[row0:row0 + rows].to(torch.float64)
         - test_u8[row0:row0 + rows].to(torch.float64))
    local = ((d * d).sum(dim=-1) / 3.0).sum()
    mse = all_reduce_sum(local, _group(mesh, axis)) / (h * w)
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                       10.0 * torch.log10((255.0 * 255.0) / mse))


# ---------------------------------------------------------------------------
# dp/tp training
# ---------------------------------------------------------------------------

def shard_params_spec(net) -> dict:
    """The sharded axis of each parameter, as tuples of PartitionSpec
    entries (None or "tp"), the JAX package's: lane tables on the S axis,
    tcnn hash-grid tables on their entries, MLP layer 0 and the hidden
    layers on rows, the last layer on columns. `net` is a ShellNetwork."""
    n_layers = len(net.mlp)

    def mlp_spec(i):
        return (None, "tp") if i == n_layers - 1 else ("tp", None)

    spec = {"mlp": [mlp_spec(i) for i in range(n_layers)]}
    if net.lane is not None:
        spec["lane"] = (None, None, None, "tp") + (None,) * (net.lane.ndim
                                                             - 4)
    else:
        spec["grids"] = [[("tp", None) for _ in net.grid]]
    return spec


def _flat_specs(net) -> list[int]:
    """The sharded dim of each of net.parameters(), in that order."""
    spec = shard_params_spec(net)
    tables = [spec["lane"]] if "lane" in spec else spec["grids"][0]
    return [s.index("tp") for s in tables + spec["mlp"]]


class ShardedNetwork(nn.Module):
    """A ShellNetwork stored as this rank's shards over the mesh's "tp"
    axis (shard_params_spec's dims): `shards` are the trainable
    parameters, `gather()` builds the whole network for a forward and
    backward pass, `reduce_grads` turns its gradients into the shards'."""

    def __init__(self, net, mesh):
        super().__init__()
        self.config = net.config
        self.mesh = mesh
        self.dims = _flat_specs(net)
        index, n = axis_coords(mesh, "tp")
        shards = []
        for p, d in zip(net.parameters(), self.dims):
            if p.shape[d] % n:
                raise ValueError(f"a {tuple(p.shape)} parameter does not "
                                 f"split into {n} shards on dim {d}")
            shards.append(nn.Parameter(
                p.detach().chunk(n, d)[index].contiguous().clone()))
        self.shards = nn.ParameterList(shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def gather_tensors(self, tensors) -> list:
        """Whole tensors from this rank's shards (one per parameter)."""
        group = _group(self.mesh, "tp")
        return [all_gather_cat(t, group, d) for t, d in zip(tensors,
                                                             self.dims)]

    def gather(self):
        """The whole ShellNetwork, trainable (a new one each call)."""
        from ..models.nbvh import ShellNetwork
        full = self.gather_tensors([s.detach() for s in self.shards])
        n_tables = len(full) - (self.config.mlp_hidden_layers + 1)
        tables, mlp = full[:n_tables], full[n_tables:]
        if self.config.grid_type == "lane":
            net = ShellNetwork(self.config, mlp, lane=tables[0])
        else:
            net = ShellNetwork(self.config, mlp, grid=tables)
        return net.requires_grad_(True)

    def reduce_grads(self, full_net):
        """Each shard's .grad from the whole network's gradients: the sum
        over the tp group scattered to its shards, then over dp."""
        tp_group = _group(self.mesh, "tp")
        dp_group = _group(self.mesh, "dp")
        for shard, p, d in zip(self.shards, full_net.parameters(),
                               self.dims):
            shard.grad = all_reduce_sum(
                reduce_scatter_sum(p.grad, tp_group, d), dp_group)


def shard_train_state(state, mesh):
    """The TrainState with this rank's shards of the network
    (ShardedNetwork) and of the AdamW moments and step count, and an
    optimizer and schedule over the shards at the state's step."""
    from ..train.trainer import TrainState
    sharded = ShardedNetwork(state.net, mesh)
    index, n = axis_coords(mesh, "tp")
    old = state.optimizer
    opt = torch.optim.AdamW(sharded.parameters(), **{
        k: old.defaults[k] for k in ("lr", "betas", "eps", "weight_decay")})
    for group in opt.param_groups:
        group["initial_lr"] = old.param_groups[0]["initial_lr"]
    for shard, p, d in zip(sharded.shards, state.net.parameters(),
                           sharded.dims):
        st = old.state.get(p)
        if st:
            opt.state[shard] = {
                "step": st["step"].clone(),
                "exp_avg": st["exp_avg"].chunk(n, d)[index].contiguous()
                .clone(),
                "exp_avg_sq": st["exp_avg_sq"].chunk(n, d)[index]
                .contiguous().clone()}
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, state.scheduler.lr_lambdas[0], last_epoch=state.step - 1)
    return TrainState(sharded, opt, sched, state.step)


def dp_shard_batch(batch, mesh, axis="dp"):
    """This rank's rows of a SegmentBatch (the batch axis is the last of
    every field): slice `index` of `extent` along `axis`, a dim name or a
    tuple of them, as torch.tensor_split cuts it."""
    index, n = axis_coords(mesh, axis)
    return type(batch)(*(torch.tensor_split(x, n, dim=-1)[index]
                         for x in batch))


def constrain_batch_dp(batch, mesh, axis="dp"):
    """The JAX package's in-jit twin of dp_shard_batch (a sharding
    constraint on a batch sampled inside the step); run eagerly it is the
    same slice, kept under this name for the trainer's sampled batches."""
    return dp_shard_batch(batch, mesh, axis)


def state_bytes(state) -> dict:
    """Bytes this rank holds of the network and of its AdamW moments."""
    params = list(state.net.parameters())
    net = sum(p.numel() * p.element_size() for p in params)
    moments = sum(t.numel() * t.element_size()
                  for p in params for k, t in state.optimizer.state.get(
                      p, {}).items() if k in ("exp_avg", "exp_avg_sq"))
    return {"network_bytes": net, "moment_bytes": moments}

