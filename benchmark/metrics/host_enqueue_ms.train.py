"""host_enqueue_ms.train: the median host time of one call into the timed
path, without a synchronise (layer: host; moves train_img_s)."""

from benchmark.lib.readers import host_enqueue_ms as read  # noqa: F401
