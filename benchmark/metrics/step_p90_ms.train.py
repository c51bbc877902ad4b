"""step_p90_ms.train: the 90th percentile of the step time on the card's
stream (layer: step; moves train_img_s)."""

from benchmark.lib.readers import call_p90_ms as read  # noqa: F401
