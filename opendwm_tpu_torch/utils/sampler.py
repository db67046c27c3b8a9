"""Variable video bucket batch sampler (OpenSora-style; the port's copy of
``opendwm_tpu/utils/sampler.py``).

Reference src/dwm/utils/sampler.py:9-198: each dataset sample is assigned a
random (resolution, frames, batch-size) bucket by configured weights; buckets
yield micro-batches whose indices encode the bucket as ``"idx-t-h-w"``
strings (consumed by DatasetAdapter); the access order is shuffled and padded
so every data-parallel rank always gets one micro-batch per step; resumable
via ``state_dict(num_steps)``.

Each bucket is one batch shape.

bucket_config format (same as the reference configs):
    {"256x448": [res_weight, [[t, batch_size, weight], ...]], ...}
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator

import numpy as np

from opendwm_tpu_torch.config import register


@register(
    "VariableVideoBatchSampler",
    aliases=("dwm.utils.sampler.VariableVideoBatchSampler",),
)
class VariableVideoBatchSampler:
    def __init__(
        self,
        dataset,
        bucket_config: dict,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.bucket = bucket_config
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.last_micro_batch_access_index = 0

        self.res = list(bucket_config.keys())
        self.res_w = np.asarray(
            [v[0] for v in bucket_config.values()], np.float64
        )
        self.res_tbw = {
            k: {
                "t_bs": [(tri[0], tri[1]) for tri in v[1]],
                "w": np.asarray([tri[2] for tri in v[1]], np.float64),
            }
            for k, v in bucket_config.items()
        }

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def group_by_bucket(self, rng: np.random.RandomState) -> OrderedDict:
        buckets: OrderedDict = OrderedDict()
        res_p = self.res_w / self.res_w.sum()
        for i in range(len(self.dataset)):
            res_i = self.res[rng.choice(len(self.res), p=res_p)]
            tb = self.res_tbw[res_i]
            p = tb["w"] / tb["w"].sum()
            t, bs = tb["t_bs"][rng.choice(len(tb["t_bs"]), p=p)]
            bucket_id = f"{res_i}-{t}-{bs}"
            buckets.setdefault(bucket_id, []).append(i)
        return buckets

    def __iter__(self) -> Iterator[list[str]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        buckets = self.group_by_bucket(rng)

        micro_batch_count: OrderedDict = OrderedDict()
        for bucket_id, data in buckets.items():
            bs = int(bucket_id.split("-")[-1])
            remainder = len(data) % bs
            if remainder:
                if self.drop_last:
                    data = data[:-remainder]
                else:
                    data = data + data[: bs - remainder]
            if self.shuffle:
                data = [data[j] for j in rng.permutation(len(data))]
            buckets[bucket_id] = data
            micro_batch_count[bucket_id] = len(data) // bs

        order = []
        for bucket_id, n in micro_batch_count.items():
            order.extend([bucket_id] * n)
        if self.shuffle:
            order = [order[j] for j in rng.permutation(len(order))]

        remainder = len(order) % self.num_replicas
        if remainder:
            if self.drop_last:
                order = order[: len(order) - remainder]
            else:
                order += order[: self.num_replicas - remainder]

        num_iters = len(order) // self.num_replicas
        start = self.last_micro_batch_access_index // self.num_replicas
        self.last_micro_batch_access_index = start * self.num_replicas
        consumed: dict[str, int] = {}
        for i in range(self.last_micro_batch_access_index):
            bid = order[i]
            consumed[bid] = consumed.get(bid, 0) + int(bid.split("-")[-1])

        for i in range(start, num_iters):
            access = order[
                i * self.num_replicas: (i + 1) * self.num_replicas
            ]
            self.last_micro_batch_access_index += self.num_replicas
            boundaries = []
            for bid in access:
                bs = int(bid.split("-")[-1])
                c = consumed.get(bid, 0)
                boundaries.append((c, c + bs))
                consumed[bid] = c + bs
            bid = access[self.rank]
            lo, hi = boundaries[self.rank]
            micro = buckets[bid][lo:hi]
            parts = bid.split("-")
            res, t = parts[0], parts[-2]
            h, w = res.split("x")
            yield [f"{idx}-{t}-{h}-{w}" for idx in micro]

        self.reset()

    def reset(self):
        self.last_micro_batch_access_index = 0

    def state_dict(self, num_steps: int) -> dict:
        return {
            "seed": self.seed,
            "epoch": self.epoch,
            "last_micro_batch_access_index": num_steps * self.num_replicas,
        }

    def load_state_dict(self, state: dict):
        self.__dict__.update(state)
