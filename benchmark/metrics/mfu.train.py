"""mfu.train: the model's operations in the window over the cards' bf16 peak
(layer: step; moves train_img_s)."""

from benchmark.lib.readers import mfu as read  # noqa: F401
