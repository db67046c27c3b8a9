"""The port's train CLI on the LiDAR trainers
(``python -m opendwm_tpu_torch.train --device cpu``), on the CPU.

- ``configs/lidar/lidar_vqvae_synthetic.json``: 2 steps of
  ``LidarCodebook`` through the CLI (the JAX-only keys skipped, the
  reservoir and code ages checkpointed with the state and restored on
  resume); the CLI never revives the codebook, as the JAX CLI never does.
- ``configs/lidar/lidar_maskgit_synthetic.json`` chained from that run:
  the tokenizer saved by ``save_model_only`` and loaded through
  ``vq_checkpoint_path``, the blank codes through ``blank_code_path``;
  2 steps train the transformer only.
- ``--device`` defaults to ``cuda`` and raises without a card.
- Every LiDAR config resolves through the port's registry, its data
  stack's classes (filesystems and readers) to the port's copies; the new
  classes resolve by name and by the JAX package's aliases;
  ``SyntheticLidarDataset``
  gives the JAX package's arrays for the same seed and index.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch import train
from opendwm_tpu_torch.config import create_instance_from_config, get_class
from opendwm_tpu_torch.pipelines import lidar_vqvae

REPO = Path(__file__).resolve().parents[1]
LIDAR = REPO / "configs/lidar"


def run_cli(*argv):
    return train.main(train.create_parser().parse_args([str(a)
                                                        for a in argv]))


@pytest.fixture(scope="module")
def vq_run(tmp_path_factory):
    """Two CLI steps of the synthetic tokenizer config, with the revival
    recorded if anything calls it."""
    out = tmp_path_factory.mktemp("vq")
    calls = []
    original = lidar_vqvae.LidarCodebook.maybe_revive_codebook
    lidar_vqvae.LidarCodebook.maybe_revive_codebook = \
        lambda self, *a, **k: calls.append(1) or original(self, *a, **k)
    try:
        state = run_cli("-c", LIDAR / "lidar_vqvae_synthetic.json", "-o",
                        out, "--device", "cpu", "--max-steps", 2,
                        "--log-steps", 1)
    finally:
        lidar_vqvae.LidarCodebook.maybe_revive_codebook = original
    return out, state, calls


def test_vqvae_synthetic_two_steps(vq_run):
    out, state, calls = vq_run
    assert isinstance(state, lidar_vqvae.VQTrainState) and state.step == 2
    assert calls == []  # no revival, as the JAX CLI
    events = [json.loads(line) for line in
              (out / "log/events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2]
    for key in ("loss", "voxel_loss", "emb_loss", "depth_loss", "sdf_loss"):
        assert all(e[key] == e[key] and e[key] > 0 for e in events), key
    # the codebook's health goes with the checkpoint
    saved = torch.load(out / "checkpoints/2/state.pt", weights_only=True)
    assert saved["extra"]["reservoir_initialized"] is True
    assert torch.equal(saved["extra"]["code_age"], state.code_age)
    assert float(state.code_age.min()) == 0.0
    assert float(state.code_age.max()) > 1.0  # unused codes aged
    # resuming restores it: one more step from step 2
    more = run_cli("-c", LIDAR / "lidar_vqvae_synthetic.json", "-o", out,
                   "--device", "cpu", "--max-steps", 3, "--resume-from", 2)
    assert more.step == 3 and more.reservoir_initialized
    assert torch.equal(more.code_age >= 0, torch.ones_like(more.code_age,
                                                           dtype=bool))


def test_maskgit_synthetic_chained_from_the_tokenizer(vq_run, tmp_path):
    out, vq_state, _ = vq_run
    snapshot = tmp_path / "vq.pt"
    ckpt_lib.save_model_only(snapshot, vq_state.model)
    blank = tmp_path / "blank.json"
    blank.write_text(json.dumps({"blank_code": [0, 5]}))
    cfg = json.loads((LIDAR / "lidar_maskgit_synthetic.json").read_text())
    cfg["vq_checkpoint_path"] = str(snapshot)
    cfg["blank_code_path"] = str(blank)
    path = tmp_path / "maskgit.json"
    path.write_text(json.dumps(cfg))

    # the frozen stages, as the CLI applies them
    pipeline = create_instance_from_config(cfg["pipeline"])
    train.load_frozen_stages(pipeline, cfg)
    assert pipeline.blank_code == (0, 5)
    for name, value in vq_state.model.state_dict().items():
        assert torch.equal(pipeline.vq.state_dict()[name], value), name

    state = run_cli("-c", path, "-o", tmp_path / "mg", "--device", "cpu",
                    "--max-steps", 2, "--log-steps", 1)
    assert state.step == 2
    events = [json.loads(line) for line in
              (tmp_path / "mg/log/events.jsonl").read_text().splitlines()]
    assert all(e["ce_loss"] > 0 and 0 <= e["acc_0"] <= 1 for e in events)
    # only the transformer trains; the checkpoint holds it alone
    saved = torch.load(tmp_path / "mg/checkpoints/2/state.pt",
                       weights_only=True)
    assert set(saved["model"]) == set(state.model.state_dict())
    assert not any(k.startswith("lidar_encoder") for k in saved["model"])


def test_device_defaults_to_cuda(tmp_path):
    assert train.create_parser().parse_args(
        ["-c", "x", "-o", "y"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli("-c", LIDAR / "lidar_vqvae_synthetic.json", "-o", tmp_path)


def test_module_entry_point(tmp_path):
    """``python -m opendwm_tpu_torch.train`` as a user runs it."""
    done = subprocess.run(
        [sys.executable, "-m", "opendwm_tpu_torch.train", "-c",
         str(LIDAR / "lidar_vqvae_synthetic.json"), "-o", str(tmp_path),
         "--device", "cpu", "--max-steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "done at step 1" in done.stdout


DATA_STACK = ("dwm.fs.", "dwm.datasets.", "ConcatMotionDataset")


def _class_names(node, out):
    if isinstance(node, dict):
        if "_class_name" in node:
            out.add(node["_class_name"])
        for value in node.values():
            _class_names(value, out)
    elif isinstance(node, list):
        for value in node:
            _class_names(value, out)
    return out


@pytest.mark.parametrize("path", sorted(LIDAR.glob("*.json")),
                         ids=lambda p: p.stem)
def test_lidar_configs_resolve(path):
    names = _class_names(json.loads(path.read_text()), set())
    for name in sorted(names - {"get_class"}):
        cls = get_class(name)
        if name.startswith(DATA_STACK):
            assert cls.__module__.startswith(("opendwm_tpu_torch.fs.",
                                              "opendwm_tpu_torch.datasets.")), \
                (name, cls.__module__)


@pytest.mark.parametrize("name,alias", [
    ("LidarCodebook", "dwm.pipelines.lidar_vqvae.LidarCodebook"),
    ("LidarVAE", "dwm.pipelines.lidar_vae.LidarVAE"),
    ("VAEPointCloud", "dwm.models.vae_point_cloud.VAEPointCloud"),
    ("VAEPointCloud", "dwm.models.lidar_vae_model.VAEPointCloud"),
    ("SyntheticLidarDataset", None),
])
def test_lidar_classes_resolve(name, alias):
    cls = get_class(name)
    assert cls.__name__ == name
    if alias is not None:
        assert get_class(alias) is cls


def test_synthetic_lidar_dataset_matches_jax():
    """The same arrays as the JAX package's ``SyntheticLidarDataset`` for
    the same seed and index (an int or a ``"{index}-..."`` key)."""
    import numpy as np

    from opendwm_tpu.datasets.synthetic import SyntheticLidarDataset as Jax

    kw = dict(size=5, sequence_length=3, point_count=40, pc_range=4.0,
              bev_size=16, seed=7)
    port, ref = get_class("SyntheticLidarDataset")(**kw), Jax(**kw)
    assert len(port) == len(ref) == 5
    for index in (0, 4, "2-x"):
        got, want = port[index], ref[index]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
