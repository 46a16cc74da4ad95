"""flops.py against counts made by hand."""

from __future__ import annotations

from portbench import flops
from portbench.tests import tiny


def test_causal_pairs():
    assert flops.causal_pairs(4) == 10
    assert flops.causal_pairs(5, window=2) == 3 + 3 * 2  # 1+2, then 2 each
    assert flops.causal_pairs(3, window=8) == 6


def test_k1_to_k4_counts():
    h, kvh, d = 4, 2, 8
    # two rows of 3 and 2 live tokens, padded to 4: 6 + 3 = 9 pairs
    f, b = flops.flash_fwd([3, 2], 4, h, kvh, d)
    assert f == 4 * h * d * 9
    q = 5 * h * d * 2
    kv = 2 * 5 * kvh * d * 2
    assert b == 2 * q + kv + 2 * 4 * 4 + 5 * h * 4
    f2, b2 = flops.flash_bwd_dq([3, 2], 4, h, kvh, d)
    f3, b3 = flops.flash_bwd_dkv([3, 2], 4, h, kvh, d)
    assert (f2, f3) == (6 * h * d * 9, 8 * h * d * 9)
    assert b2 == q + kv + q + 2 * 5 * h * 4 + 2 * 4 * 4 + q
    assert b3 == b2 - q + kv
    # one step of 2 rows over prompts of 3 and 2 with 1 generated each
    f4, b4 = flops.decode_attn([3, 2], 1, h, kvh, d)
    assert f4 == 4 * h * d * 7
    assert b4 == 7 * kvh * d * 4 + 2 * 2 * h * d * 2 + 2 * 4
    assert flops.bound_s(989e12, 0) == 1.0
    assert flops.bound_s(0, 3.35e12) == 1.0


def test_a_micro_step_by_hand():
    model = tiny.config("llava-mistral-7b")["model"]
    llm = model["llm"]
    d, f, h, kvh, dh, n_l = 64, 128, 4, 2, 16, 2
    dense = 2 * n_l * (d * h * dh + 2 * d * kvh * dh + h * dh * d + 3 * d * f)
    assert flops.llm_dense_flops(llm) == dense
    r = 4
    lora = 2 * n_l * r * ((d + h * dh) + 2 * (d + kvh * dh) + (h * dh + d)
                          + 3 * (d + f))
    assert flops.lora_flops(llm, r) == lora
    head = 2 * d * llm["vocab_size"]
    # one pos/neg pair of 10 and 12 tokens, one reference row of 9; the
    # tiny window (24) cuts nothing
    pn, ref = [10, 12], [9]
    pairs = {n: n * (n + 1) // 2 for n in (9, 10, 12)}
    attn = 4 * h * dh * n_l
    frozen = 9 * (dense + head) + attn * pairs[9]
    policy_tokens = 31
    policy_pairs = pairs[10] + pairs[12] + pairs[9]
    policy = policy_tokens * (dense + lora + head) + attn * policy_pairs
    backward = policy_tokens * (dense + head + 2 * lora) + 2 * attn * \
        policy_pairs
    vision = flops.vision_flops(model, 2)
    assert flops.train_step_flops(model, pn, ref, r) == (
        vision + frozen + policy + backward)
    v = model["vision"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1  # 5 with the class
    vd, vf = v["hidden_size"], v["intermediate_size"]
    tower = (2 * 4 * 3 * 14 * 14 * vd
             + 1 * (2 * n * (4 * vd * vd + 2 * vd * vf) + 4 * vd * n * n))
    proj = 2 * 4 * (vd * d + d * d)
    assert vision == 2 * (tower + proj)


def test_an_eval_batch_by_hand():
    model = tiny.config("llava-mpt-7b")["model"]
    llm = model["llm"]
    dense = flops.llm_dense_flops(llm)
    head = flops.head_flops(llm)
    attn = 4 * llm["hidden_size"] * llm["num_layers"]
    # one row of 6 prompt tokens, 3 served: the prefill with its head at
    # the last position, then 2 decode steps over 7 and 8 keys
    want = (flops.vision_flops(model, 1) + 6 * dense + attn * 21 + head
            + 2 * (dense + head) + attn * (7 + 8))
    assert flops.eval_batch_flops(model, [6], [3]) == want
