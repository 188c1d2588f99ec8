"""The data layer: datasets, mappers, loaders and the tokenizer.

``data_registry`` maps a data config's ``type`` to its dataset class, as
the reference's ``data/__init__.py``: ``annoindexed`` (annotation JSON,
``anno_dataset.AnnoIndexedDataset``) and ``srcindexed`` (tar-shard
streams, ``src_dataset.SrcIndexedDataset``), imported at first use.
"""


class _Registry(dict):
    def __missing__(self, key):
        if key == "annoindexed":
            from vast_tpu_torch.data.anno_dataset import AnnoIndexedDataset

            self[key] = AnnoIndexedDataset
            return AnnoIndexedDataset
        if key == "srcindexed":
            from vast_tpu_torch.data.src_dataset import SrcIndexedDataset

            self[key] = SrcIndexedDataset
            return SrcIndexedDataset
        raise KeyError(key)


data_registry = _Registry()
