"""Synthetic inputs of the LM stack (`repro/archs/frontends.py`), dense
family: the same numpy draw as the JAX package, so the same seed gives
the same tokens in both. The audio and vision frontends wait for ROADMAP
queue 1 item 18."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.utils import resolve_device


def make_batch(cfg: ArchConfig, cell_kind: str, batch: int, seq: int,
               seed: int = 0, device: "str | torch.device" = "cuda") -> dict:
    """{"tokens": int32 [batch, seq]} for train/prefill; {"token": [batch,
    1], "pos": seq // 2} (pos a host int) for decode; tensors on
    `device`."""
    if cfg.family == "audio" or cfg.frontend == "vision_stub":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} frontend "
                                  "waits for ROADMAP queue 1 item 18")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, seq),
                                         dtype=np.int32)).to(dev)
    if cell_kind in ("train", "prefill"):
        return {"tokens": toks}
    return {"token": toks[:, :1], "pos": seq // 2}
