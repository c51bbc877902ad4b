"""Work tables of `deeplabv2-r101-multilevel`: the multi-level adversarial
step (traffic path 'train') and the bf16 batched evaluation ('eval')."""

from benchmark.lib import plans


def plan(cfg: dict, traffic: dict) -> dict:
    n, cards = traffic["batch_per_card"], traffic.get("cards", 1)
    if traffic["path"] == "train":
        return plans.train_multilevel(cfg, n, cards)
    if traffic["path"] == "eval":
        return plans.eval_batch(cfg, n, cards)
    raise ValueError(f"no work table for path {traffic['path']!r}")
