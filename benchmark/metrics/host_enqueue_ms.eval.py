"""host_enqueue_ms.eval: the median host time of one call into the timed
path, without a synchronise (layer: host; moves eval_img_s)."""

from benchmark.lib.readers import host_enqueue_ms as read  # noqa: F401
