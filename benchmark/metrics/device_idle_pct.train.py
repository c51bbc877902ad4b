"""device_idle_pct.train: the share of the traced window with no kernel or
copy on the card (layer: device; moves train_img_s)."""

from benchmark.lib.readers import device_idle_pct as read  # noqa: F401
