"""Architecture registry: one module per architecture, as the reference's
`repro.configs`.

Each ported `<arch>.py` exposes `config() -> ModelConfig` with the
published numbers and `reduced() -> ModelConfig` for CPU tests, copied from
the reference.  This port has the six configs whose layers are all
attention without experts (`PORTED`); the other four need model families
it does not port yet, and `get_config` raises NotImplementedError for them
(ROADMAP Queue 1 item 5)."""

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

PORTED = ["hubert_xlarge", "deepseek_7b", "glm4_9b", "codeqwen15_7b",
          "nemotron_4_15b", "qwen2_vl_7b"]

# What each unported config needs (ROADMAP Queue 1 item 5).
UNPORTED = {
    "llama4_maverick_400b_a17b": "models/moe.py",
    "mixtral_8x7b": "models/moe.py",
    "mamba2_780m": "models/ssm.py",
    "recurrentgemma_9b": "models/rglru.py",
}

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name in UNPORTED:
        raise NotImplementedError(
            f"config {mod_name} needs {UNPORTED[mod_name]}, which "
            f"repro_torch does not port yet (ROADMAP Queue 1 item 5)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.config()
