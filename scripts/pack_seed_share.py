"""How dense chip_smoke.py's packed batches are across seeds.

chip_smoke.py's packed-train phase draws its documents' text lengths from
PACK_SEED (N(256, 96) clipped to 96-512, TRAIN7B_PACK.json's recipe) and
requires that each of its first PACK_STEPS packed batches holds >= 3
samples and every pn row >= 3 documents. This script runs the same
PackSamples and the same batcher (halva_tpu_torch/train/pack.py) over
seeds 0..N-1 and prints how often that holds, the samples a batch takes,
and the documents a pn row holds. Packing reads only the lengths, so the
items carry 2 x 2 pixel images; the host alone runs it.

    python scripts/pack_seed_share.py [--seeds 200]
"""

import argparse
import collections
import itertools
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    args = ap.parse_args()
    cfg = types.SimpleNamespace(
        vision=types.SimpleNamespace(image_size=2),
        llm=types.SimpleNamespace(vocab_size=cs.LLAVA_V15_7B.llm.vocab_size),
        num_image_tokens=cs.LLAVA_V15_7B.num_image_tokens)
    passing, first, whole, rows = [], collections.Counter(), \
        collections.Counter(), collections.Counter()
    for seed in range(args.seeds):
        ds = cs.PackSamples(cfg, seed=seed)
        batches = list(cs.pack_batcher(cfg).batches(iter(ds.items)))
        head = batches[:cs.PACK_STEPS]
        docs = [int(b["pn_segment_ids"][r].max()) for b in head
                for r in range(cs.PACK_ROWS)]
        n = [int(b["n_samples"]) for b in head]
        passing.append(min(n) >= 3 and min(docs) >= 3)
        first.update(n)
        rows.update(docs)
        whole.update(int(b["n_samples"]) for b in batches)
    share = lambda c: {k: round(v / sum(c.values()), 4)  # noqa: E731
                       for k, v in sorted(c.items())}
    print(f"seeds 0-{args.seeds - 1}, {cs.PACK_SAMPLES} samples each, "
          f"{cs.PACK_ROWS} pn + {cs.PACK_REF_ROWS} ref rows x {cs.PACK_SEQ}, "
          f"<= {cs.PACK_BATCH} samples a batch")
    print(f"seeds whose first {cs.PACK_STEPS} batches all hold >= 3 samples "
          f"and >= 3 documents a pn row: {sum(passing)} of {len(passing)} "
          f"({sum(passing) / len(passing):.4f}); PACK_SEED "
          f"{cs.PACK_SEED} passes: {passing[cs.PACK_SEED]}")
    print(f"samples a batch, first {cs.PACK_STEPS} batches: {share(first)}")
    print(f"documents a pn row, first {cs.PACK_STEPS} batches: "
          f"{share(rows)}")
    print(f"samples a batch, every batch of the {cs.PACK_SAMPLES} samples: "
          f"{share(whole)}; mean "
          f"{sum(k * v for k, v in whole.items()) / sum(whole.values()):.4f}")


if __name__ == "__main__":
    main()
