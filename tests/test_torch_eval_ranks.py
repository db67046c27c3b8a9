"""Evaluation, preview and streaming across data ranks, on the CPU in
spawned gloo ranks (``torch_dist_workers``: no JAX in them), every world-2
case in one group.

JAX keeps its arrays global: one device generates its rows, while the
metrics and the noise (``PRNGKey(step)``) are those of the global batch.
Here each data rank generates its rows from its rows of the global draws,
and the metrics' states are merged over the data ranks before
``compute``. At world 2 (fsdp, one row a rank):

- the train CLI with ``--evaluation-steps 1`` logs the one-process CLI's
  ``evaluation/fid_proxy`` within 1e-5 relative (before the merge, rank
  0 logged its half of the batches, scored on noise of its local shape);
- the evaluate CLI returns the one-process CLI's results on both ranks,
  within 1e-5;
- CTSD's ``evaluate_pipeline`` given the global ``jax.random.normal(
  PRNGKey(step), (2, ...))`` noise is within 1e-4 of JAX's on both ranks,
  scoring the latents (the tiny VAE's decoded frames give distances of
  ~7e-4, differences of O(1) terms, where the one-process port already
  sits 2e-4 from JAX);
- MaskGIT's ``evaluate_pipeline`` from a generator (its categorical
  steps in chunks that straddle the ranks' rows): voxel IoU and diff
  equal to one process's, Chamfer within 1e-6;
- the preview CLI: rank 0's frames equal the one-process file's within
  1e-5, rank 1 writes nothing;
- the stream at batch 2 is split (each rank its row, within 1e-5 of the
  one-process rows); at batch 1 both ranks serve the whole stream, and
  the streaming CLI's rank 0 writes the one-process frames, rank 1
  nothing;
- on a (tp 2) mesh the two ranks share their rows: one data rank, and
  the merge counts each row once; on a (dp 2) mesh the merge equals one
  instance fed every rank's rows in order.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opendwm_tpu.config as jax_config
from opendwm_tpu.metrics import frechet as jfr
from opendwm_tpu_torch import config as port_config
from opendwm_tpu_torch import evaluate, preview, streaming, train
from opendwm_tpu_torch.metrics import (
    CustomMeanMetric,
    FrechetPairedMetric,
    PointCloudJSD,
    VoxelIoU,
)
from opendwm_tpu_torch.perf import land_eval
from opendwm_tpu_torch.pipelines import lidar_maskgit

import torch_dist_workers as workers
from test_torch_eval_pipelines import _eval_batches, _jax_state
from test_torch_eval_pipelines import _pipeline_config
from test_torch_eval_pipelines import ctsd_pipes  # noqa: F401
from test_torch_pipeline import C, H, T, V, W
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SYNTHETIC = REPO / "configs/ctsd/ctsd_35_6views_video_synthetic.json"
STREAM = REPO / "configs/ctsd/ctsd_streaming_synthetic.json"
CLI_REL, JAX_REL, FRAME_TOL, CHAMFER_REL = 1e-5, 1e-4, 1e-5, 1e-6
EVAL_STEP, MASKGIT_SEED, STREAM_SEED = 5, 13, 21
MASKGIT_CHUNK_ROWS = 5  # a chunk straddles the ranks' 16 rows each


def _cli_config(tmp: Path) -> Path:
    """The synthetic config cut to 2 blocks and 4 inference steps, batches
    of 2 (a row a rank at world 2), 2 validation batches scored by an
    8-feature ``fid_proxy`` (16 samples a side)."""
    config = json.loads(SYNTHETIC.read_text())
    config["pipeline"]["model"].update(
        num_layers=2, dual_attention_layers=[0], crossview_block_layers=[0],
        temporal_block_layers=[1])
    config["pipeline"]["inference_config"]["inference_steps"] = 4
    config.update(batch_size=2, evaluation_batches=2)
    config["metrics"]["fid_proxy"]["num_features"] = 8
    return land_eval.write_config(config, tmp / "cfg.json")


def _preview_config(tmp: Path) -> Path:
    config = json.loads((tmp / "cfg.json").read_text())
    config = land_eval.with_vae(config, land_eval.TINY_VAE,
                                land_eval.land_tiny_vae(tmp / "vae"))
    config["preview_dataset"] = dict(config["validation_dataset"], size=2)
    config["preview_collate_fn"] = config["validation_collate_fn"]
    return land_eval.write_config(config, tmp / "preview.json")


def _events(out: Path) -> list:
    return [json.loads(line) for line in
            (out / "log" / "events.jsonl").read_text().splitlines()]


def _pair(batches: list) -> dict:
    """Two one-row window batches stacked into a batch of 2."""
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _jax_eval(params, batches):
    """JAX's evaluation of ``batches`` (its noise ``PRNGKey(EVAL_STEP)``'s
    normal of the global batch), scoring the latents (no VAE, as the JAX
    CLI scores them)."""
    jax_pipe = jax_config.create_instance_from_config(_pipeline_config())
    return jax_pipe.evaluate_pipeline(
        _jax_state(params), EVAL_STEP,
        batches=[{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        metrics={"fid_proxy": jfr.FrechetPairedMetric(6),
                 "shrunk": jfr.FrechetPairedMetric(6, shrinkage=1e-3)})


def _maskgit_one_process(batches):
    """The small MaskGIT's weights and its one-process evaluation from a
    generator, its categorical steps in chunks of ``MASKGIT_CHUNK_ROWS``
    rows; and that chunk in logits."""
    torch.manual_seed(3)
    pipe = workers.maskgit_pipeline()
    state_dict = {"model": copy.deepcopy(pipe.model.state_dict()),
                  "vq": copy.deepcopy(pipe.vq.state_dict())}
    chunk = MASKGIT_CHUNK_ROWS * workers._MODEL["n_e"]
    saved, lidar_maskgit.SAMPLE_CHUNK_ELEMS = \
        lidar_maskgit.SAMPLE_CHUNK_ELEMS, chunk
    try:
        want = pipe.evaluate_pipeline(
            pipe.model, batches, torch.Generator().manual_seed(MASKGIT_SEED))
    finally:
        lidar_maskgit.SAMPLE_CHUNK_ELEMS = saved
    return state_dict, want, chunk


def _maskgit_batches() -> list:
    rng = np.random.default_rng(1)
    b, img = workers.MASKGIT_B, workers.MASKGIT_IMG
    out = []
    for _ in range(2):
        pts = rng.uniform(-8, 8, (b, 1, 256, 3)).astype(np.float32)
        pts[..., 2] = rng.uniform(-1, 1, (b, 1, 256))
        out.append({
            "lidar_points": torch.from_numpy(pts),
            "lidar_points_mask": torch.ones(b, 1, 256, dtype=torch.bool),
            "3dbox_bev_images": torch.from_numpy(
                rng.uniform(size=(b, img, img, 3)).astype(np.float32))})
    return out


def _stream_ticks(b: int, n: int = 4) -> list:
    rng = np.random.default_rng(b)
    return [{"encoder_hidden_states": torch.from_numpy(rng.standard_normal(
                (b, 1, 2, 4, 24)).astype(np.float32)),
             "pooled_projections": torch.from_numpy(rng.standard_normal(
                 (b, 1, 2, 16)).astype(np.float32))} for _ in range(n)]


def _metric_updates(seed: int, n: int = 2) -> list:
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((3, 4, 4, 3))
                              .astype(np.float32)),
             torch.from_numpy(rng.standard_normal((3, 4, 4, 3))
                              .astype(np.float32) + 0.5),
             torch.from_numpy(rng.uniform(size=(3, 4, 4, 4)) > 0.5),
             torch.from_numpy(rng.uniform(size=(3, 4, 4, 4)) > 0.5),
             torch.from_numpy(rng.uniform(-60, 60, (50, 3))
                              .astype(np.float32)))
            for _ in range(n)]


def _one_instance(updates) -> dict:
    """The metrics of ``metric_states_case`` in one process, fed
    ``updates`` in order."""
    metrics = {"mean": CustomMeanMetric(), "fid": FrechetPairedMetric(4),
               "iou": VoxelIoU(), "jsd": PointCloudJSD(bins=8)}
    for real, fake, gt, pred, points in updates:
        metrics["mean"].update(real)
        metrics["fid"].update(real, fake)
        metrics["iou"].update(gt, pred)
        metrics["jsd"].update(points, points * 0.5)
    return {k: m.compute() for k, m in metrics.items()}


def _rows(updates, rank: int) -> list:
    """Rank ``rank``'s half (of 2) of each of every update's tensors."""
    return [tuple(x.chunk(2)[rank] for x in u) for u in updates]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ctsd_pipes):  # noqa: F811
    tmp = tmp_path_factory.mktemp("ranks")
    cfg = _cli_config(tmp)
    preview_cfg = _preview_config(tmp)
    cases, ref = {}, {}

    # the train CLI with evaluation, and the evaluate CLI
    train_argv = ["-c", str(cfg), "--device", "cpu", "--max-steps", "1",
                  "--log-steps", "1", "--evaluation-steps", "1"]
    train.main(train.create_parser().parse_args(
        train_argv + ["-o", str(tmp / "train_one")]))
    ref["train"] = _events(tmp / "train_one")
    cases["train"] = ("cli_case", ("train", train_argv + [
        "-o", str(tmp / "train_two")]))
    eval_argv = ["-c", str(cfg), "--device", "cpu", "--max-batches", "2"]
    ref["evaluate"] = evaluate.main(evaluate.create_parser().parse_args(
        eval_argv + ["-o", str(tmp / "eval_one")]))
    cases["evaluate"] = ("cli_case", ("evaluate", eval_argv + [
        "-o", str(tmp / "eval_two")]))

    # the preview CLI, each rank its own output directory
    preview_argv = ["-c", str(preview_cfg), "--device", "cpu"]
    with workers.saved_preview_frames():
        ref["preview"] = preview.main(preview.create_parser().parse_args(
            preview_argv + ["-o", str(tmp / "preview_one")]))
    cases["preview"] = ("cli_case", ("preview", preview_argv + [
        "-o", str(tmp / "preview_two_{rank}")]))

    # CTSD's evaluate_pipeline on the global JAX noise, scoring latents
    _, params, port_pipe = ctsd_pipes
    singles = _eval_batches(4)
    batches = [_pair(singles[:2]), _pair(singles[2:])]
    ref["jax"] = {k: float(v) for k, v in _jax_eval(params, batches).items()}
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(EVAL_STEP), (2, T, V, H, W, C), jnp.float32)))
    cases["jax"] = ("ctsd_eval_case", (
        _pipeline_config(), port_pipe.model.state_dict(),
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
        EVAL_STEP, [noise, noise], 6))

    # MaskGIT from a generator
    mg_batches = _maskgit_batches()
    mg_sd, ref["maskgit"], chunk = _maskgit_one_process(mg_batches)
    cases["maskgit"] = ("maskgit_eval_case", (mg_sd, mg_batches,
                                              MASKGIT_SEED, chunk))

    # the stream at batch 2 (split) and 1 (whole), and its CLI at batch 1
    stream = json.loads(STREAM.read_text())
    stream_cfg = stream["pipeline"]
    torch.manual_seed(0)
    stream_sd = port_config.create_instance_from_config(
        copy.deepcopy(stream_cfg)).model.state_dict()
    ref["stream"] = {}
    for b in (2, 1):
        args = (stream_cfg, stream_sd, (b, *stream["latent_shape"][1:]),
                _stream_ticks(b), STREAM_SEED)
        ref["stream"][b] = workers.stream_case(0, 1, *args)["frames"]
        cases[f"stream{b}"] = ("stream_case", args)
    stream_argv = ["-c", str(STREAM), "--device", "cpu", "--max-frames", "2"]
    streaming.main(streaming.create_parser().parse_args(
        stream_argv + ["-o", str(tmp / "stream_one")]))
    cases["stream_cli"] = ("cli_case", ("streaming", stream_argv + [
        "-o", str(tmp / "stream_two_{rank}")]))

    # the merge on a (tp 2) mesh (shared rows) and a (dp 2) mesh
    shared = _metric_updates(7)
    ref["tp"] = _one_instance(shared)
    cases["tp"] = ("metric_states_case", ({"dp": 1, "fsdp": 1, "tp": 2},
                                          shared))
    split = [tuple(torch.cat([a, b]) for a, b in zip(u0, u1))
             for u0, u1 in zip(_metric_updates(8), _metric_updates(9))]
    ref["dp"] = _one_instance(split)
    cases["dp"] = ("metric_states_case", ({"dp": 2, "fsdp": 1, "tp": 1},
                                          [_rows(split, r) for r in range(2)],
                                          True))

    two = workers.run_group("run_cases", 2, cases)
    return {"tmp": tmp, "ref": ref, "two": two}


def test_train_cli_logs_the_global_evaluation(runs):
    """The fault: at world 2, rank 0 logged its half of the validation
    batches, scored on noise of its local shape."""
    tmp = runs["tmp"]
    want = [e for e in runs["ref"]["train"] if "evaluation/fid_proxy" in e]
    got = [e for e in _events(tmp / "train_two")
           if "evaluation/fid_proxy" in e]
    assert [e["step"] for e in got] == [e["step"] for e in want] == [1]
    assert want[0]["evaluation/fid_proxy"] > 0
    assert got[0]["evaluation/fid_proxy"] == pytest.approx(
        want[0]["evaluation/fid_proxy"], rel=CLI_REL)
    assert [r["train"] for r in runs["two"]] == [1, 1]


def test_evaluate_cli_at_world_two(runs):
    want = runs["ref"]["evaluate"]
    assert want.keys() == {"evaluation/fid_proxy"}
    for rank in runs["two"]:
        got = rank["evaluate"]
        assert got.keys() == want.keys()
        assert got["evaluation/fid_proxy"] == pytest.approx(
            want["evaluation/fid_proxy"], rel=CLI_REL)
    assert runs["two"][0]["evaluate"] == runs["two"][1]["evaluate"]
    assert len(_events(runs["tmp"] / "eval_two")) == 1  # rank 0 logs


def test_ctsd_evaluate_matches_jax_at_world_two(runs):
    want = runs["ref"]["jax"]
    for rank in runs["two"]:
        got = rank["jax"]
        assert got.keys() == want.keys()
        for k in want:
            assert want[k] > 0
            assert abs(got[k] - want[k]) / want[k] <= JAX_REL, k


def test_maskgit_evaluate_at_world_two(runs):
    want = runs["ref"]["maskgit"]
    assert all(np.isfinite(v) for v in want.values())
    for rank in runs["two"]:
        got = rank["maskgit"]
        assert got["evaluation/voxel_iou"] == want["evaluation/voxel_iou"]
        assert got["evaluation/voxel_diff"] == want["evaluation/voxel_diff"]
        assert got["evaluation/chamfer"] == pytest.approx(
            want["evaluation/chamfer"], rel=CHAMFER_REL)


def test_preview_cli_at_world_two(runs):
    tmp = runs["tmp"]
    (want_path,) = runs["ref"]["preview"]
    got_paths = [rank["preview"] for rank in runs["two"]]
    assert got_paths[1] == [None]
    assert Path(got_paths[0][0]).name == Path(want_path).name
    assert Path(got_paths[0][0]).parent.parent == tmp / "preview_two_0"
    assert not (tmp / "preview_two_1").exists() or \
        not any((tmp / "preview_two_1").rglob("*"))
    want = np.load(want_path + ".npy")
    got = np.load(got_paths[0][0] + ".npy")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FRAME_TOL


def test_stream_at_batch_two_is_split(runs):
    want = runs["ref"]["stream"][2]
    assert len(want) == 2
    for r, rank in enumerate(runs["two"]):
        got = rank["stream2"]
        assert got["split"]
        assert len(got["frames"]) == len(want)
        for frame, ref in zip(got["frames"], want):
            assert frame.shape[0] == 1
            assert (frame[0] - ref[r]).abs().max() <= FRAME_TOL


def test_stream_at_batch_one_is_served_whole(runs):
    tmp = runs["tmp"]
    want = runs["ref"]["stream"][1]
    for rank in runs["two"]:
        got = rank["stream1"]
        assert not got["split"]
        for frame, ref in zip(got["frames"], want):
            assert (frame - ref).abs().max() <= FRAME_TOL
    one = sorted((tmp / "stream_one").iterdir())
    assert [p.name for p in one] == ["frame_000000.png", "frame_000001.png"]
    assert [p.read_bytes() for p in one] == [
        (tmp / "stream_two_0" / p.name).read_bytes() for p in one]
    assert not (tmp / "stream_two_1").exists()


def test_tp_mesh_counts_each_row_once(runs):
    """Both ranks of a (tp 2) mesh hold the same rows: the data group has
    one member, and the merged metrics are one process's."""
    want = runs["ref"]["tp"]
    for rank in runs["two"]:
        got = rank["tp"]
        assert got["data_group"] == 1
        # the Fréchet sums in one all_gather, every host state in one
        # all_gather_object a metric
        assert got["collectives"] == {"gloo:all_gather": 1,
                                      "gloo:all_gather_object": 4}
        for k, v in want.items():
            assert got["results"][k] == pytest.approx(v, rel=1e-6), k


def test_dp_mesh_merge_is_one_instance_in_order(runs):
    want = runs["ref"]["dp"]
    for rank in runs["two"]:
        got = rank["dp"]
        assert got["data_group"] == 2
        for k, v in want.items():
            assert got["results"][k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("chunk_rows", [1, 5, 16, 64])
def test_global_gumbel_gives_each_rank_its_rows(ranks, chunk_rows,
                                                monkeypatch):
    """MaskGIT's categorical noise over data ranks: each rank's rows, as
    ``sample_tokens`` asks for them in its own chunks, are its rows of one
    process's chunked draw of the global batch, and every rank's generator
    ends where one process's does."""
    n_e, rows = 7, 16
    monkeypatch.setattr(lidar_maskgit, "SAMPLE_CHUNK_ELEMS", chunk_rows * n_e)
    one = torch.Generator().manual_seed(3)
    gumbel, finish = lidar_maskgit.global_gumbel(one, "cpu", n_e,
                                                 rows * ranks)
    want = gumbel(0, rows * ranks)  # one request: every chunk in order
    finish()
    for rank in range(ranks):
        gen = torch.Generator().manual_seed(3)
        gumbel, finish = lidar_maskgit.global_gumbel(gen, "cpu", n_e, rows,
                                                     rank, ranks)
        got = torch.cat([gumbel(r0, min(r0 + chunk_rows, rows))
                         for r0 in range(0, rows, chunk_rows)])
        finish()
        assert torch.equal(got, want[rank * rows:(rank + 1) * rows])
        assert torch.equal(gen.get_state(), one.get_state())
