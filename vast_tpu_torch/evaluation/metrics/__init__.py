"""Caption metrics of the PyTorch port (see ``coco_eval``)."""
