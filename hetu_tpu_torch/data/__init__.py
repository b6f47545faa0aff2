"""Data of the port (``hetu_tpu.data`` counterpart): datasets, the
prefetching dataloader over the native core, and variable-length
buckets.  Host code on numpy; the batches go to the graph as feeds."""
from .bucket import (Bucket, build_fake_batch_and_len, ffd_pack,
                     get_input_and_label_buckets, get_sorted_batch_and_len)
from .dataloader import Dataloader
from .dataset import Dataset, GPTJsonDataset, GPTSeqDataset, TensorDataset

__all__ = [
    "Bucket", "build_fake_batch_and_len", "ffd_pack",
    "get_input_and_label_buckets", "get_sorted_batch_and_len", "Dataloader",
    "Dataset", "GPTJsonDataset", "GPTSeqDataset", "TensorDataset",
]
