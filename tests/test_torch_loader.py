"""The port's prefetch loader, bucket sampler and train CLI loader
(``opendwm_tpu_torch/datasets/loader.py``, ``utils/sampler.py``,
``train.py``) against the JAX package's: the same batches for the same
seed from ``PrefetchLoader`` and ``batch_iterator``, with and without the
bucket sampler, the same micro-batches from the sampler (replicas, ranks,
epochs, resume); the loader's own behaviour as ``tests/test_loader.py``
holds the JAX one; and the train CLI on a nuScenes-format archive read
through the port's ``CombinedZipFileSystem`` with ``num_workers`` 2 and a
``training_sampler``: 2 steps of a tiny LiDAR UNet config whose batches
equal those of JAX's loader, and a resumed run that skips the same
batches."""

import copy
import json
import time
from pathlib import Path

import fsspec
import numpy as np
import pytest
from test_datasets_common import FakeDataset
from test_loader import SlowDataset, collate
from torch_port_helpers import assert_same_item

from opendwm_tpu import train as jax_train
from opendwm_tpu.datasets.common import CollateFnIgnoring as JaxCollate
from opendwm_tpu.datasets.common import DatasetAdapter as JaxAdapter
from opendwm_tpu.datasets.loader import PrefetchLoader as JaxLoader
from opendwm_tpu.datasets.nuscenes import MotionDataset as JaxNuScenes
from opendwm_tpu.utils.sampler import VariableVideoBatchSampler as JaxSampler
from opendwm_tpu_torch import train
from opendwm_tpu_torch.datasets.common import DatasetAdapter
from opendwm_tpu_torch.datasets.loader import PrefetchLoader, index_batches
from opendwm_tpu_torch.perf import lidar_train_tiny, nuscenes_fixture
from opendwm_tpu_torch.utils.sampler import VariableVideoBatchSampler

REPO = Path(__file__).resolve().parents[1]
BUCKETS = {"256x448": [1.0, [[8, 2, 0.5], [16, 1, 0.5]]],
           "128x128": [0.5, [[4, 3, 1.0]]]}


def take(it, n):
    return [next(it) for _ in range(n)]


# -- the sampler --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_replicas=1, rank=0, seed=0),
    dict(num_replicas=2, rank=1, seed=3),
    dict(num_replicas=3, rank=2, seed=1, drop_last=True),
    dict(num_replicas=1, rank=0, seed=5, shuffle=False),
], ids=["one", "two_ranks", "drop_last", "ordered"])
def test_sampler_as_jax(kw):
    port = VariableVideoBatchSampler(FakeDataset(41), BUCKETS, **kw)
    ref = JaxSampler(FakeDataset(41), BUCKETS, **kw)
    for epoch in range(3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref)
    state = port.state_dict(num_steps=4)
    assert state == ref.state_dict(num_steps=4)
    port.load_state_dict(state)
    ref.load_state_dict(state)
    assert list(port) == list(ref)


# -- the index stream, the loader and batch_iterator --------------------------

def test_index_stream_skips_whole_batches():
    full = take(index_batches(10, 3, seed=4), 9)
    assert take(index_batches(10, 3, seed=4, skip=5), 4) == full[5:]
    sampler = VariableVideoBatchSampler(FakeDataset(12), BUCKETS, seed=2)
    full = take(index_batches(12, 1, sampler), 12)
    sampler = VariableVideoBatchSampler(FakeDataset(12), BUCKETS, seed=2)
    assert take(index_batches(12, 1, sampler, skip=7), 5) == full[7:]
    with pytest.raises(ValueError, match="smaller than one batch"):
        next(index_batches(2, 3))


@pytest.mark.parametrize("with_sampler", [False, True])
@pytest.mark.parametrize("workers", [0, 1, 3])
def test_batches_as_jax(with_sampler, workers):
    """The port's loader (``train.build_loader``: ``batch_iterator`` at 0
    workers, else ``PrefetchLoader``) against JAX's, across epochs."""
    config = {"batch_size": 4,
              "training_dataloader": {"num_workers": workers}}
    if with_sampler:
        config["training_sampler"] = {
            "_class_name": "VariableVideoBatchSampler",
            "bucket_config": BUCKETS, "seed": 7}
    dataset = DatasetAdapter(FakeDataset(13)) if with_sampler \
        else FakeDataset(13)
    it, loader = train.build_loader(config, dataset, collate_items, seed=9)
    sampler = JaxSampler(JaxAdapter(FakeDataset(13)), BUCKETS, seed=7) \
        if with_sampler else None
    ref_ds = JaxAdapter(FakeDataset(13)) if with_sampler else FakeDataset(13)
    if workers:
        ref_loader = JaxLoader(ref_ds, 4, collate_items, sampler, 9,
                               num_workers=workers)
        ref = iter(ref_loader)
    else:
        ref = jax_train.batch_iterator(ref_ds, 4, collate_items, sampler, 9)
    try:
        for got, want in zip(take(it, 10), take(ref, 10)):
            assert_same_item(got, want)
    finally:
        if loader is not None:
            loader.close()
        if workers:
            ref_loader.close()


def collate_items(items):
    # JAX's batch_iterator indexes with numpy ints, its PrefetchLoader (and
    # the port's loaders) with ints: the indices compare as ints
    return {"index": [int(i["index"]) for i in items],
            "x": np.stack([i["x"] for i in items]),
            "bucket": [i.get("_bucket") for i in items]}


def test_resumed_loader_skips_the_same_batches():
    config = {"batch_size": 3, "training_dataloader": {"num_workers": 2}}
    full, loader = train.build_loader(config, FakeDataset(11), collate_items,
                                      seed=1)
    want = take(full, 8)
    loader.close()
    for workers in (0, 2):
        config["training_dataloader"]["num_workers"] = workers
        it, loader = train.build_loader(config, FakeDataset(11),
                                        collate_items, seed=1, skip=5)
        for got, ref in zip(take(it, 3), want[5:]):
            assert_same_item(got, ref)
        if loader is not None:
            loader.close()


# -- the loader's own behaviour (tests/test_loader.py for the port) ----------

def test_loader_matches_sequential_order():
    loader = PrefetchLoader(SlowDataset(delay=0.0), batch_size=4,
                            collate_fn=collate, seed=7, num_workers=3)
    got = [b["x"][:, 0] for b in take(iter(loader), 8)]
    loader.close()
    order = np.random.default_rng(7).permutation(32)
    for g, i in zip(got, range(0, 32, 4)):
        np.testing.assert_array_equal(g, order[i:i + 4].astype(float))


def test_loader_fetches_concurrently_and_propagates_errors():
    ds = SlowDataset(delay=0.05)
    loader = PrefetchLoader(ds, batch_size=8, collate_fn=collate,
                            num_workers=8)
    next(iter(loader))
    loader.close()
    assert ds.max_concurrent >= 2

    class Broken(SlowDataset):
        def __getitem__(self, i):
            raise RuntimeError("boom")

    loader = PrefetchLoader(Broken(n=8), batch_size=2, collate_fn=collate,
                            num_workers=1, prefetch_batches=1)
    it = iter(loader)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    del it
    time.sleep(0.2)
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_reiteration_restarts_the_stream():
    loader = PrefetchLoader(SlowDataset(n=16, delay=0.0), batch_size=4,
                            collate_fn=collate, seed=3, num_workers=2)
    first = next(iter(loader))
    again = next(iter(loader))
    loader.close()
    np.testing.assert_array_equal(first["x"], again["x"])
    assert len(take(iter(PrefetchLoader(
        SlowDataset(n=8, delay=0.0), 4, collate, num_workers=2)), 5)) == 5


# -- the train CLI on a nuScenes-format archive -------------------------------

def tiny_unet_config(archive: str) -> dict:
    """``configs/lidar/lidar_diffusion_unet_temporal_ns.json`` with
    ``perf/lidar_train_tiny.py``'s tiny UNet and tokenizer, its nuScenes
    reader on ``archive`` (2 frames, 1024 points) under a
    ``DatasetAdapter``, a bucket sampler of micro-batches of 2 and 2
    loader threads."""
    cfg = json.loads((REPO / "configs/lidar/lidar_diffusion_unet_temporal_"
                      "ns.json").read_text())
    pipe = cfg["pipeline"]
    pipe["model"] = dict(lidar_train_tiny.UNET,
                         _class_name=pipe["model"]["_class_name"])
    ae = pipe["autoencoder"]
    ae["voxelizer"].update(lidar_train_tiny.UNET_VOXELIZER)
    enc = dict(lidar_train_tiny.UNET_ENCODER)
    ae["lidar_encoder"] = dict(enc, codebook_dim=16,
                               _class_name=ae["lidar_encoder"]["_class_name"])
    ae["lidar_decoder"] = dict(enc, codebook_dim=8, depth=4, density_feats=4,
                               _class_name=ae["lidar_decoder"]["_class_name"])
    ae["latent_dim"] = 8
    pipe["common_config"].update(text_embeddings_dim=16,
                                 pooled_text_embeddings_dim=16)
    del cfg["autoencoder_checkpoint_path"]
    ds = cfg["training_dataset"]
    ds["fs"]["paths"] = [archive]
    ds.update(sequence_length=2, fps_stride_tuples=[[2, 1.0]],
              max_point_count=1024)
    cfg["training_dataset"] = {"_class_name": "DatasetAdapter",
                               "base_dataset": ds}
    cfg["training_sampler"] = {
        "_class_name": "dwm.utils.sampler.VariableVideoBatchSampler",
        "bucket_config": {"640x640": [1.0, [[2, 2, 1.0]]]}, "seed": 0}
    cfg["training_dataloader"] = {"num_workers": 2, "prefetch_factor": 2}
    return cfg


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc")
    info = nuscenes_fixture.write_archive(root, samples=10, points=600,
                                          boxes=5)
    nuscenes_fixture.extract(info["archive"], root / "tree")
    return info, root / "tree"


def run_recording(monkeypatch, *argv):
    """``train.main`` on ``argv``; returns the state and every host batch
    the loop took, in order."""
    seen = []
    to_device = train.to_device_batch
    monkeypatch.setattr(train, "to_device_batch",
                        lambda b, d: seen.append(b) or to_device(b, d))
    state = train.main(train.create_parser().parse_args(
        [str(a) for a in argv]))
    monkeypatch.setattr(train, "to_device_batch", to_device)
    return state, seen


def test_cli_trains_from_the_archive_as_jax_loads_it(archive, tmp_path,
                                                     monkeypatch, capsys):
    info, tree = archive
    cfg = tiny_unet_config(info["archive"])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    state, batches = run_recording(monkeypatch, "-c", path, "-o", out,
                                   "--device", "cpu", "--max-steps", 2,
                                   "--log-steps", 1,
                                   "--checkpointing-steps", 1)
    assert state.step == 2 and len(batches) == 2
    assert "dropped fields that are not arrays" in capsys.readouterr().out
    events = [json.loads(line) for line in
              (out / "log/events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2]
    assert all(np.isfinite(e["sd_loss"]) and e["data_wait_s"] >= 0 and
               e["step_s"] > 0 for e in events)

    # JAX's loader (two threads) over the JAX reader on the extracted tree
    base = copy.deepcopy(cfg["training_dataset"]["base_dataset"])
    kw = {k: v for k, v in base.items() if k not in ("_class_name", "fs")}
    jax_ds = JaxAdapter(JaxNuScenes(
        fsspec.filesystem("dir", path=str(tree)), **kw))
    sampler = JaxSampler(jax_ds, cfg["training_sampler"]["bucket_config"],
                         seed=0)
    loader = JaxLoader(jax_ds, 4, JaxCollate(), sampler,
                       cfg.get("generator_seed", 0), num_workers=2)
    want = take(iter(loader), 3)
    loader.close()
    for got, ref in zip(batches, want):
        assert_same_item(got, ref)
    assert batches[0]["lidar_points"].shape == (2, 2, 1024, 3)

    # resumed from step 1, the loop takes JAX's second batch, then its third
    state, resumed = run_recording(monkeypatch, "-c", path, "-o", out,
                                   "--device", "cpu", "--max-steps", 3,
                                   "--resume-from", 1)
    assert state.step == 3 and len(resumed) == 2
    for got, ref in zip(resumed, want[1:]):
        assert_same_item(got, ref)
