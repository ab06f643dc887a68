"""Architecture registry: one module per architecture, as the reference's
`repro.configs`.

Each `<arch>.py` exposes `config() -> ModelConfig` with the published
numbers and `reduced() -> ModelConfig` for CPU tests, copied from the
reference."""

from __future__ import annotations

import importlib

ARCHS = [
    "hubert_xlarge",
    "llama4_maverick_400b_a17b",
    "mixtral_8x7b",
    "deepseek_7b",
    "glm4_9b",
    "codeqwen15_7b",
    "nemotron_4_15b",
    "mamba2_780m",
    "recurrentgemma_9b",
    "qwen2_vl_7b",
]

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.config()
