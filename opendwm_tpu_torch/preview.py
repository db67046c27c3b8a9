"""Preview CLI of the port (``opendwm_tpu/preview.py``): generation over
the config's ``preview_dataset``, its prompts rewritten by
``prompt_rewriting`` (``add``, ``replace`` or ``template``), each batch's
composited preview written under ``{output}/preview``.

    python -m opendwm_tpu_torch.preview -c config.json -o output/ \\
        [--device cuda|cpu] [--checkpoint STEP] [--max-batches N]

``--device`` defaults to ``cuda`` and raises without a card; the model and
its frozen stages are built as in the evaluate CLI, and ``--checkpoint``
loads the train CLI's checkpoint of that step under ``output/``.
"""

from __future__ import annotations

import argparse

import torch

from opendwm_tpu_torch import checkpoint as ckpt_lib
from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.train import build_pipeline, read_config, \
    to_device_batch


def rewrite_prompts(batch: dict, settings: dict) -> dict:
    """The batch with its ``image_description`` rewritten
    (``opendwm_tpu/preview.py:22-50``): ``add`` appends ``text``,
    ``replace`` puts ``text`` in place of each description, ``template``
    formats ``text`` with it; nested (frame, view) lists keep their
    shape."""
    if not settings or "image_description" not in batch:
        return batch
    mode = settings.get("mode")
    text = settings.get("text", "")

    def rewrite(s: str) -> str:
        if mode == "add":
            return f"{s} {text}"
        if mode == "replace":
            return text
        if mode == "template":
            return text.format(s)
        return s

    out = dict(batch)
    out["image_description"] = [
        [[rewrite(s) for s in view] if isinstance(view, list)
         else rewrite(view) for view in frame]
        if isinstance(frame, list) else rewrite(frame)
        for frame in batch["image_description"]
    ]
    return out


def create_parser():
    parser = argparse.ArgumentParser(
        description="Write generation previews from a JSON config "
                    "(PyTorch port).")
    parser.add_argument("-c", "--config-path", required=True)
    parser.add_argument("-o", "--output-path", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--max-batches", type=int, default=1)
    return parser


def main(args=None) -> list:
    args = args or create_parser().parse_args()
    config, device = read_config(args)
    torch.manual_seed(config.get("generator_seed", 0))
    pipeline = build_pipeline(config, device)
    dataset = create_instance_from_config(config["preview_dataset"])
    collate = create_instance_from_config(
        config.get("preview_collate_fn", {})) or (lambda items: items[0])
    prompt_settings = config.get("prompt_rewriting")

    bs = config.get("batch_size", 1)
    state = pipeline.init_state()
    if args.checkpoint is not None:
        ckpt_lib.load_checkpoint(args.output_path, args.checkpoint, state)
    paths = []
    for i in range(args.max_batches):
        host = collate([dataset[i * bs + j] for j in range(bs)])
        if prompt_settings:
            host = rewrite_prompts(host, prompt_settings)
        path = pipeline.preview_pipeline(
            state, to_device_batch(host, device), args.output_path, i)
        print(f"wrote {path}", flush=True)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
