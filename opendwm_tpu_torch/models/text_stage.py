"""Prompt encoding stage (``opendwm_tpu/models/text_stage.py``), in
PyTorch: ``image_description`` strings into the conditioning the
pipelines read from a batch (``encoder_hidden_states``,
``pooled_projections`` and their ``uncond_`` twins, shaped
``(b, t, v, ...)``).

Tokenizers are injected: any object with ``__call__(texts, max_length) ->
ids`` works (real CLIP and T5 tokenizers need vocabulary files).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.text_encoders import sd3_prompt_embeddings


def flatten_descriptions(desc) -> list[str]:
    """Nested (t, v) description lists → a flat list."""
    if isinstance(desc, str):
        return [desc]
    out = []
    for item in desc:
        out.extend(flatten_descriptions(item))
    return out


class WhitespaceTokenizer:
    """Minimal tokenizer for tests and smoke runs: word ids hashed into a
    fixed vocabulary, framed by bos/eos like CLIP's. The ids come from
    Python's ``hash`` of each word, so they differ between processes unless
    ``PYTHONHASHSEED`` is fixed (as in the JAX package)."""

    def __init__(self, vocab_size: int = 1000, bos: int = 0, eos: int = 2,
                 pad: int = 1):
        self.vocab_size = vocab_size
        self.bos, self.eos, self.pad = bos, eos, pad

    def __call__(self, texts: Sequence[str], max_length: int) -> np.ndarray:
        out = np.full((len(texts), max_length), self.pad, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos]
            for word in text.split()[: max_length - 2]:
                ids.append(3 + (hash(word) % (self.vocab_size - 3)))
            ids.append(self.eos)
            out[i, : len(ids)] = ids
        return out


def _grid(desc) -> tuple[int, int, int]:
    """(b, t, v) of a nested description list."""
    return (len(desc), len(desc[0]),
            len(desc[0][0]) if isinstance(desc[0][0], list) else 1)


def _device_of(module, device):
    return torch.device(device) if device is not None else \
        next(module.parameters()).device


@register("SD3TextStage")
class SD3TextStage:
    """Dual CLIP (+ optional T5) prompt encoding for the SD3 family, under
    ``torch.no_grad()``. Adds ``encoder_hidden_states``,
    ``pooled_projections``, ``uncond_encoder_hidden_states`` and
    ``uncond_pooled_projections`` (the empty prompt's), all shaped
    ``(b, t, v, ...)``; ``device``: where the ids go (default: the first
    CLIP's)."""

    def __init__(
        self,
        clip_l, clip_l_tokenizer,
        clip_g, clip_g_tokenizer,
        t5=None, t5_tokenizer=None,
        clip_max_length: int = 77,
        t5_max_length: int = 154,
        caption_dim: int = 4096,
        device=None,
    ):
        self.clip_l, self.clip_g, self.t5 = clip_l, clip_g, t5
        self.tok_l, self.tok_g, self.tok_t5 = (
            clip_l_tokenizer, clip_g_tokenizer, t5_tokenizer)
        self.clip_max_length = clip_max_length
        self.t5_max_length = t5_max_length
        self.caption_dim = caption_dim
        self.device = _device_of(clip_l, device)

    def _ids(self, tokenizer, texts, length):
        return torch.as_tensor(tokenizer(texts, length), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def encode_flat(self, texts: list[str]):
        """(tokens, pooled) of each text."""
        out_l = self.clip_l(self._ids(self.tok_l, texts,
                                      self.clip_max_length))
        out_g = self.clip_g(self._ids(self.tok_g, texts,
                                      self.clip_max_length))
        t5_out = None
        if self.t5 is not None:
            t5_out = self.t5(self._ids(self.tok_t5, texts,
                                       self.t5_max_length))
        return sd3_prompt_embeddings(out_l, out_g, t5_out,
                                     caption_dim=self.caption_dim)

    def __call__(self, batch: dict) -> dict:
        """Reads ``batch["image_description"]`` ((b, t, v) nested strings)."""
        desc = batch["image_description"]
        shape = _grid(desc)
        flat = flatten_descriptions(desc)
        tokens, pooled = self.encode_flat(flat)
        uncond_tokens, uncond_pooled = self.encode_flat([""] * len(flat))
        out = dict(batch)
        out["encoder_hidden_states"] = tokens.reshape(
            shape + tokens.shape[1:])
        out["pooled_projections"] = pooled.reshape(shape + pooled.shape[1:])
        out["uncond_encoder_hidden_states"] = uncond_tokens.reshape(
            shape + tokens.shape[1:])
        out["uncond_pooled_projections"] = uncond_pooled.reshape(
            shape + pooled.shape[1:])
        return out


@register("CLIPTextStage")
class CLIPTextStage:
    """Single-CLIP prompt encoding for the SD 2.1 family: the hidden state
    at ``hidden_state_index`` (the penultimate by default), under
    ``torch.no_grad()``."""

    def __init__(self, clip, tokenizer, max_length: int = 77,
                 hidden_state_index: int = -2, device=None):
        self.clip = clip
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.hidden_state_index = hidden_state_index
        self.device = _device_of(clip, device)

    @torch.no_grad()
    def encode_flat(self, texts: list[str]):
        ids = torch.as_tensor(self.tokenizer(texts, self.max_length),
                              dtype=torch.long, device=self.device)
        _, _, hidden = self.clip(ids)
        return hidden[self.hidden_state_index]

    def __call__(self, batch: dict) -> dict:
        desc = batch["image_description"]
        shape = _grid(desc)
        flat = flatten_descriptions(desc)
        emb = self.encode_flat(flat)
        uncond = self.encode_flat([""] * len(flat))
        out = dict(batch)
        out["encoder_hidden_states"] = emb.reshape(shape + emb.shape[1:])
        out["uncond_encoder_hidden_states"] = uncond.reshape(
            shape + emb.shape[1:])
        return out
