"""The data layer: datasets, mappers, loaders and the tokenizer.

``data_registry`` maps a data config's ``type`` to its dataset class, as
the reference's ``data/__init__.py``. Only ``annoindexed`` (annotation
JSON, ``anno_dataset.AnnoIndexedDataset``) is ported; ``srcindexed``
(tar-shard streams) raises ``NotImplementedError``.
"""


class _Registry(dict):
    def __missing__(self, key):
        if key == "annoindexed":
            from vast_tpu_torch.data.anno_dataset import AnnoIndexedDataset

            self[key] = AnnoIndexedDataset
            return AnnoIndexedDataset
        if key == "srcindexed":
            raise NotImplementedError(
                "srcindexed (tar-shard streaming) datasets are not ported "
                "yet: they come with the pretraining slice")
        raise KeyError(key)


data_registry = _Registry()
