"""Tiny versions of the benchmark's configurations and cells for CPU
tests: the same architectures and traffic kinds at a few dozen widths."""

from __future__ import annotations

import copy

from portbench import harness

TINY_LLM = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 128,
            "num_layers": 2, "num_heads": 4, "max_position_embeddings": 4096}
TINY_VISION = {"image_size": 28, "patch_size": 14, "hidden_size": 32,
               "intermediate_size": 64, "num_layers": 2, "num_heads": 2}


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_config(name))
    llm = cfg["model"]["llm"]
    llm.update(TINY_LLM)
    if llm["num_kv_heads"]:
        llm["num_kv_heads"] = 2
    if llm["sliding_window"]:
        llm["sliding_window"] = 24  # shorter than the spliced rows
    if not llm["gated_mlp"]:
        llm["intermediate_size"] = 256
    cfg["model"]["vision"].update(TINY_VISION)
    # fp32 on the CPU: the plain route then matches the reference to
    # rounding, far inside every limit, and a fault stands out
    cfg["dtype"] = "float32"
    return cfg


TRAFFIC = {
    "dpa_train": {"batches": 3, "row_tokens": 40, "prompt_tokens": [8, 14],
                  "image_at": 4, "phrases": [1, 3], "phrase_tokens": [2, 4],
                  "trace_first": 1, "trace_units": 1},
    "eval_batches": {"batches": 3, "prompt_tokens": [8, 14], "image_at": 4,
                     "prompt_bucket": 8, "check_tokens": 24,
                     "control_batches": 3,
                     "trace_first": 1, "trace_units": 1},
}


def cell(name: str) -> dict:
    c = copy.deepcopy(harness.load_cell(name))
    t = c["traffic"]
    t.update(TRAFFIC[t["kind"]])
    if "new_tokens" in t and "median" in t["new_tokens"]:
        t["new_tokens"] = {"median": 6, "sigma": 0.4, "min": 2, "max": 12}
    if "job" in c:
        c["job"].update({"lora_r": 4, "lora_alpha": 8, "lora_b_std": 0.05})
    return c
