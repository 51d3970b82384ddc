"""The port's command line,
``python -m underwater_image_restoration_torch.cli``: trains
(``ModelTrainer``) or, with ``--evaluate``, loads weights and restores a
directory of images."""
