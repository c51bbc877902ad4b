"""Command-line entry points: `python -m adaptsegnet_tpu_torch.cli.evaluate`,
`python -m adaptsegnet_tpu_torch.cli.iou`."""
