"""device_idle_pct.eval: the share of the traced window with no kernel or
copy on the card (layer: device; moves eval_img_s)."""

from benchmark.lib.readers import device_idle_pct as read  # noqa: F401
