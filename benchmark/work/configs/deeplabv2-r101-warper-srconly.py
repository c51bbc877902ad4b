"""Work tables of `deeplabv2-r101-warper-srconly`: the fork's source-only
step with the Warper (traffic path 'train')."""

from benchmark.lib import plans


def plan(cfg: dict, traffic: dict) -> dict:
    if traffic["path"] == "train":
        return plans.train_source_only_warper(
            cfg, traffic["batch_per_card"], traffic.get("cards", 1))
    raise ValueError(f"no work table for path {traffic['path']!r}")
