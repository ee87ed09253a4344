"""Assigned input shapes. Decode shapes lower ``serve_step`` (one new token
against a KV cache of ``seq_len``); train/prefill lower full sequences."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    # long-context decode must be sub-quadratic: attention archs switch to
    # their sliding-window variant when this flag is set.
    requires_subquadratic: bool = False


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode",
                            requires_subquadratic=True),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
