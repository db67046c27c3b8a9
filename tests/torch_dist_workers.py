"""Spawned gloo ranks for the port's multi-device tests.

The children import torch and the port only, never JAX: ``run_group``
spawns ``world`` processes on a ``file://`` store, each runs
``worker(rank, world, *args)`` of this module and ``torch.save``s what it
returns; the parent loads every rank's result. A rank's exception is
re-raised in the parent with its traceback.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, out_dir, name, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            result = globals()[name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, path)
    except BaseException:  # noqa: BLE001 - handed to the parent
        torch.save({"error": traceback.format_exc()}, path)


def run_group(name: str, world: int, *args):
    """[rank 0's result, rank 1's, ...] of ``name(rank, world, *args)``
    run in ``world`` spawned gloo ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_entry, args=(world, store, tmp, name, args),
                           nprocs=world, start_method="spawn")
        results = []
        for rank in range(world):
            got = torch.load(os.path.join(tmp, f"{rank}.pt"),
                             weights_only=False)
            if "error" in got:
                raise RuntimeError(f"rank {rank} failed:\n{got['error']}")
            results.append(got["ok"])
    return results


def run_cases(rank, world, cases):
    """Every (worker name, args) case in one group: {name: result}."""
    return {key: globals()[fn](rank, world, *args)
            for key, (fn, args) in cases.items()}


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def ring_case(rank, world, q, k, v, do, tp):
    """Replicated and sharded rings over a ``tp`` axis of size ``tp``
    (dp = world / tp): this rank's output and gradients of each."""
    from opendwm_tpu_torch.ops import ring_attention as ra
    from opendwm_tpu_torch.parallel.mesh import (
        MeshSpec,
        axis_group,
        axis_rank,
        make_mesh,
    )

    mesh = make_mesh(MeshSpec(dp=world // tp, fsdp=1, tp=tp))
    group = axis_group(mesh, "tp")
    r = axis_rank(mesh, "tp")
    out = {}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    rep = ra.ring_attention_replicated(*leaves, group)
    rep.backward(do)
    out["replicated"] = [rep.detach(), *(t.grad for t in leaves)]
    local = [t.chunk(tp, 1)[r].clone().requires_grad_() for t in (q, k, v)]
    sh = ra.ring_attention_sharded(*local, group)
    sh.backward(do.chunk(tp, 1)[r])
    out["sharded"] = [sh.detach(), *(t.grad for t in local)]
    try:
        ra.ring_attention_replicated(q[:, :-1], k[:, :-1], v[:, :-1], group)
        out["indivisible"] = None
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def block(params, h, *conds):
    out = torch.tanh(h @ params["w"] + params["b"])
    for c in conds:
        out = out + c
    return out


def gpipe_case(rank, world, stages, x, conds, m, pp, batch_axis, grads):
    """``pipeline_apply`` on a (dp = world / pp, pp) mesh: the output, and
    with ``grads`` the gradients of sum(out^2) for the stacked params
    (this rank's stage row), x and the conditioning."""
    from opendwm_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from opendwm_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_stage_params,
    )

    mesh = make_mesh(MeshSpec(dp=world // pp, fsdp=1, pp=pp))
    stacked = stack_stage_params(stages)
    if grads:
        stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        x = x.clone().requires_grad_()
        conds = tuple(c.clone().requires_grad_() for c in conds)
    try:
        out = pipeline_apply(block, stacked, x, mesh, microbatches=m,
                             conds=conds, batch_axis=batch_axis)
    except ValueError as err:
        return {"error": str(err)}
    result = {"out": out.detach()}
    if grads:
        (out ** 2).sum().backward()
        result["params"] = {k: v.grad for k, v in stacked.items()}
        result["x"] = x.grad
        result["conds"] = [c.grad for c in conds]
    return result


# ---------------------------------------------------------------------------
# Sharded training
# ---------------------------------------------------------------------------


def full(t):
    """A DTensor gathered whole (a collective); other tensors as they are."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def ctsd_pipeline(cfg, state_dict, mesh_spec=None, policy=None):
    """The port's CTSD pipeline of ``cfg`` holding ``state_dict``, on the
    mesh of ``mesh_spec`` (a dict) under ``policy``."""
    import copy

    from opendwm_tpu_torch import config

    cfg = copy.deepcopy(cfg)
    if mesh_spec is not None:
        cfg["mesh"] = dict(mesh_spec)
        cfg["sharding_policy"] = policy
    pipe = config.create_instance_from_config(cfg)
    pipe.model.load_state_dict(state_dict)
    return pipe


def sharded_step(rank, world, cfg, state_dict, batch, draws, mesh_spec,
                 policy, steps=1, save=None, load=None):
    """``steps`` train steps of the CTSD pipeline on this rank's slices of
    ``batch`` and ``draws`` (a list, one a step; an int: the seed of the
    generator the steps draw from, as the train CLI's): the losses, grad
    norms and every parameter after them, whole. ``load``: a checkpoint
    (dir, step) to resume from first; ``save``: a (dir, step) to save the
    state to after the steps."""
    from opendwm_tpu_torch import checkpoint
    from opendwm_tpu_torch.parallel.sharding import shard_batch

    pipe = ctsd_pipeline(cfg, state_dict, mesh_spec, policy)
    state = pipe.init_state()
    if load is not None:
        checkpoint.load_checkpoint(load[0], load[1], state)
    local = shard_batch(batch, pipe.mesh)
    generator = torch.Generator().manual_seed(draws) \
        if isinstance(draws, int) else None
    losses, norms = [], []
    for i in range(steps):
        state, metrics = pipe.train_step(
            state, local, generator,
            draws=None if generator is not None
            else shard_batch(draws[i], pipe.mesh))
        losses.append(float(metrics["sd_loss"]))
        norms.append(float(metrics["grad_norm"]))
    if save is not None:
        checkpoint.save_checkpoint(save[0], save[1], state)
    params = {n: full(p).detach().clone()
              for n, p in state.model.named_parameters()}
    shardings = pipe.state_shardings(state)
    placements = {n: str(getattr(p, "placements", None))
                  for n, p in state.model.named_parameters()}
    moments = {n: str(getattr(st.get("exp_avg"), "placements", None))
               for n, st in zip(
                   (n for n, _ in state.model.named_parameters()),
                   (state.optimizer.state[p]
                    for p in state.model.parameters()))}
    return {"loss": losses, "grad_norm": norms, "params": params,
            "shardings": shardings, "placements": placements,
            "moments": moments, "step": state.step}


@contextlib.contextmanager
def torchrun_env(rank, world):
    """RANK, WORLD_SIZE and LOCAL_RANK set as ``torchrun`` sets them (the
    group is the one this rank joined)."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def train_cli(rank, world, argv):
    """The train CLI as ``torchrun`` starts it: the state's step and every
    parameter after it, whole."""
    from opendwm_tpu_torch import train

    with torchrun_env(rank, world):
        state = train.main(train.create_parser().parse_args(argv))
    return {"step": state.step,
            "params": {n: full(p).detach().clone()
                       for n, p in state.model.named_parameters()}}


# a small MaskGIT (the full-width config's structure: one frame, the extra
# embedding with the perturbation on, the layout adapter)
MASKGIT_IMG, MASKGIT_B = 32, 2
_VOX = dict(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, step=0.5,
            z_min=-1.0, z_max=1.0, z_step=0.25)
_ENC = dict(img_size=32, patch_size=8, in_chans=8, embed_dim=8, num_heads=2,
            depth=6, codebook_dim=12, window_size=2)
_MODEL = dict(n_e=24, e_dim=12, img_size=(4, 4), hidden_dim=16, depth=2,
              num_heads=2, window_size=2, use_extra_embedding=True,
              enable_perturbation=True, perturbation_ratio=0.3,
              perturbation_topk=3,
              condition_adapter_config=dict(
                  in_channels=3, channels=[16, 16],
                  is_downblocks=[False, False], num_res_blocks=1,
                  downscale_factor=8))
_TRAIN = {"task_type_ratio": 0.0, "max_reference_frame": 3,
          "3dbox_condition_ratio": 0.5, "hdmap_condition_ratio": 0.5,
          "max_norm_for_grad_clip": 1.0}


def maskgit_pipeline(mesh=None):
    """The small MaskGIT pipeline (torch's default init)."""
    from opendwm_tpu_torch.models import vq_point_cloud as vq
    from opendwm_tpu_torch.models.maskgit import BidirectionalTransformer
    from opendwm_tpu_torch.ops.voxelize import Voxelizer
    from opendwm_tpu_torch.pipelines.lidar_maskgit import MaskGITPipeline

    tokenizer = vq.VQPointCloud(
        Voxelizer(**_VOX), vq.VectorQuantizer(24, 12, cosine_similarity=True),
        vq.VQEncoder(**_ENC), vq.VQDecoder(**dict(_ENC, depth=4,
                                                  density_feats=4)))
    return MaskGITPipeline(tokenizer, BidirectionalTransformer(**_MODEL),
                           training_config=_TRAIN,
                           optimizer_config={"lr": 1e-3,
                                             "weight_decay": 0.01},
                           mesh=mesh)


def maskgit_step(rank, world, state_dict, batch, draws):
    """One MaskGIT train step under its default policy (DDP) on a (dp =
    world) mesh, on this rank's slice of the batch: its loss and the
    transformer's parameters after it."""
    from opendwm_tpu_torch.parallel.sharding import shard_batch

    pipe = maskgit_pipeline({"dp": world, "fsdp": 1, "tp": 1})
    pipe.model.load_state_dict(state_dict["model"])
    pipe.vq.load_state_dict(state_dict["vq"])
    state = pipe.init_state()
    state, metrics = pipe.train_step(state, shard_batch(batch, pipe.mesh),
                                     draws=shard_batch(draws, pipe.mesh))
    return {"loss": float(metrics["ce_loss"]), "policy": pipe.policy,
            "params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()}}


# ---------------------------------------------------------------------------
# Meshes and sharding
# ---------------------------------------------------------------------------


def mesh_case(rank, world, shapes, batch):
    """This rank's view of the meshes over ``world`` ranks: the shapes and
    axis names of ``make_mesh`` and ``mesh_for_policy``, the sharded
    dimensions of ``shapes`` on a (dp 2, fsdp 2) mesh under each policy and
    on a (tp 4) mesh, and this rank's ``shard_batch`` slices of ``batch``."""
    from opendwm_tpu_torch.parallel.mesh import (
        MeshSpec,
        axis_rank,
        make_mesh,
        mesh_for_policy,
    )
    from opendwm_tpu_torch.parallel.sharding import (
        data_rank,
        param_shardings,
        shard_batch,
    )

    out = {"meshes": {}}
    for name, spec in (("default", MeshSpec()),
                       ("dp2fsdp2", MeshSpec(dp=2, fsdp=2)),
                       ("tp4", MeshSpec(dp=1, fsdp=1, tp=4)),
                       ("pp2", MeshSpec(dp=1, fsdp=2, pp=2))):
        mesh = make_mesh(spec)
        out["meshes"][name] = (tuple(mesh.shape), mesh.mesh_dim_names)
    for policy in ("ddp", "fsdp", "hsdp"):
        mesh = mesh_for_policy(policy)
        out["meshes"][policy] = (tuple(mesh.shape), mesh.mesh_dim_names)
    mesh = make_mesh(MeshSpec(dp=2, fsdp=2))
    out["shardings"] = {policy: param_shardings(shapes, mesh, policy)
                        for policy in ("ddp", "fsdp", "hsdp")}
    out["shardings"]["tp"] = param_shardings(
        shapes, make_mesh(MeshSpec(dp=1, fsdp=1, tp=4)), "tp")
    out["data_rank"] = (data_rank(mesh), axis_rank(mesh, "dp"),
                        axis_rank(mesh, "fsdp"))
    out["batch"] = shard_batch(batch, mesh)
    return out


# ---------------------------------------------------------------------------
# The stage-sliced flagship DiT
# ---------------------------------------------------------------------------


def dit_pp_case(rank, world, model_kw, state_dict, inputs, microbatches):
    """``pipelined_dit_forward`` of the port's DiT over a (pp = world)
    mesh: the output."""
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
    from opendwm_tpu_torch.parallel import dit_pipeline
    from opendwm_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    model = DiTCrossviewTemporal(**model_kw)
    model.set_view_embedding_width(
        state_dict["view_embedding.linear_1.weight"].shape[1])
    model.load_state_dict(state_dict)
    mesh = make_mesh(MeshSpec(dp=1, fsdp=1, pp=world))
    with torch.no_grad():
        return dit_pipeline.pipelined_dit_forward(
            model, **inputs, n_stages=world, mesh=mesh,
            microbatches=microbatches)


def flagship_tp_case(rank, world, stage_kw, seed, pp, tp, microbatches):
    """Tiny flagship stages drawn from ``seed`` (the same on every rank),
    GPipe'd over pp with the joint attention ringed over tp, and their
    sequential chain without the ring: both outputs."""
    from opendwm_tpu_torch.parallel import dit_pipeline
    from opendwm_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    def build(sp_axis):
        return dit_pipeline.build_flagship_stages(
            torch.Generator().manual_seed(seed), n_stages=pp, sp_axis=sp_axis,
            **stage_kw)

    stage, stacked, (h0, temb0) = build("tp")
    plain = build(None)[0]
    mesh = make_mesh(MeshSpec(dp=world // (pp * tp), fsdp=1, tp=tp, pp=pp))
    with torch.no_grad():
        out = dit_pipeline.flagship_pipeline_apply(
            stage, stacked, h0, temb0, mesh, microbatches=microbatches)
        ref = dit_pipeline.flagship_sequential_apply(plain, stacked, h0,
                                                     temb0)
    return {"out": out, "ref": ref}


# ---------------------------------------------------------------------------
# Evaluation, preview and streaming across data ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def saved_preview_frames():
    """The CTSD preview writes, beside each file, the frames it encodes
    (``<path>.npy``), so that they can be compared without the codec."""
    import numpy as np

    from opendwm_tpu_torch.pipelines import ctsd

    save = ctsd.save_tensor_to_video

    def save_and_keep(path, fps, frames):
        out = save(path, fps, frames)
        np.save(out + ".npy", np.asarray(frames))
        return out

    ctsd.save_tensor_to_video = save_and_keep
    try:
        yield
    finally:
        ctsd.save_tensor_to_video = save


def cli_case(rank, world, module, argv):
    """The port's CLI ``module`` (``train``, ``evaluate``, ``preview``,
    ``streaming``) as ``torchrun`` starts it, ``{rank}`` in an argument
    replaced by the rank: what its ``main`` returns (the train CLI: the
    state's step), the preview's frames saved beside its file."""
    import importlib

    argv = [a.replace("{rank}", str(rank)) for a in argv]
    cli = importlib.import_module(f"opendwm_tpu_torch.{module}")
    with torchrun_env(rank, world), saved_preview_frames():
        out = cli.main(cli.create_parser().parse_args(argv))
    return out.step if module == "train" else out


def ctsd_eval_case(rank, world, cfg, state_dict, batches, step, noise,
                   features):
    """CTSD's ``evaluate_pipeline`` (``FrechetPairedMetric`` of
    ``features`` over the latents, plain and with shrinkage) on this data
    rank's rows of the global ``batches``, given the global batches'
    ``noise``: its results."""
    from opendwm_tpu_torch.metrics.frechet import FrechetPairedMetric
    from opendwm_tpu_torch.parallel.sharding import shard_batch

    pipe = ctsd_pipeline(cfg, state_dict)
    return pipe.evaluate_pipeline(
        None, step, batches=[shard_batch(b, pipe.mesh) for b in batches],
        metrics={"fid_proxy": FrechetPairedMetric(features),
                 "shrunk": FrechetPairedMetric(features, shrinkage=1e-3)},
        noise=noise)


def maskgit_eval_case(rank, world, state_dict, batches, seed, chunk_elems):
    """The small MaskGIT's ``evaluate_pipeline`` on a (dp = world) mesh, on
    this data rank's rows of the global ``batches``, its draws from a
    generator seeded with ``seed`` (the categorical steps in chunks of
    ``chunk_elems`` logits): its results."""
    from opendwm_tpu_torch.parallel.sharding import shard_batch
    from opendwm_tpu_torch.pipelines import lidar_maskgit

    lidar_maskgit.SAMPLE_CHUNK_ELEMS = chunk_elems
    pipe = maskgit_pipeline({"dp": world, "fsdp": 1, "tp": 1})
    pipe.model.load_state_dict(state_dict["model"])
    pipe.vq.load_state_dict(state_dict["vq"])
    return pipe.evaluate_pipeline(
        pipe.model, [shard_batch(b, pipe.mesh) for b in batches],
        torch.Generator().manual_seed(seed))


def stream_case(rank, world, cfg, state_dict, latent_shape, ticks, seed):
    """``ticks`` ticks of the streaming pipeline of ``cfg`` for the global
    ``latent_shape`` (``ticks``: the global conditions of each tick), its
    initial and tail noise from a generator seeded with ``seed``: whether
    the stream is split over the data ranks, and the frames this rank
    emits."""
    from opendwm_tpu_torch.parallel.sharding import shard_batch

    pipe = ctsd_pipeline(cfg, state_dict)
    split = pipe.splits_stream(latent_shape)

    def rows(batch):
        return shard_batch(batch, pipe.mesh) if split else batch

    template = rows({k: torch.cat([v] * latent_shape[1], 1)
                     for k, v in ticks[0].items()})
    state = pipe.reset_streaming(latent_shape, template,
                                 torch.Generator().manual_seed(seed))
    frames = []
    for tick in ticks:
        state = pipe.send_frame_condition(state, rows(tick))
        state, frame, ready = pipe.receive_frame(state)
        if ready:
            frames.append(frame)
    return {"split": state.split, "frames": frames}


def metric_states_case(rank, world, mesh_spec, updates, by_rank=False):
    """Metrics of every kind fed ``updates`` (``by_rank``: ``updates[rank]``,
    else every rank the same rows, as the ranks of a (tp) mesh share them)
    on a mesh of ``mesh_spec``, then merged over the data ranks: their
    results, the data group's size and the collectives issued."""
    import torch.distributed as dist

    from opendwm_tpu_torch.metrics import (
        CustomMeanMetric,
        FrechetPairedMetric,
        PointCloudJSD,
        VoxelIoU,
    )
    from opendwm_tpu_torch.parallel import collectives
    from opendwm_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from opendwm_tpu_torch.parallel.sharding import data_group

    mesh = make_mesh(MeshSpec(**mesh_spec))
    if by_rank:
        updates = updates[rank]
    metrics = {"mean": CustomMeanMetric(), "fid": FrechetPairedMetric(4),
               "iou": VoxelIoU(), "jsd": PointCloudJSD(bins=8)}
    for real, fake, gt, pred, points in updates:
        metrics["mean"].update(real)
        metrics["fid"].update(real, fake)
        metrics["iou"].update(gt, pred)
        metrics["jsd"].update(points, points * 0.5)
    collectives.reset_collective_counts()
    collectives.reduce_metric_states(metrics, mesh, len(updates))
    return {"results": {k: m.compute() for k, m in metrics.items()},
            "data_group": dist.get_world_size(data_group(mesh)),
            "collectives": collectives.collective_counts()}
