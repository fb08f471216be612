"""Segments, dictionaries, bitmap indexes, the synthetic generator and
array conversion."""
from druid_tpu_torch.data.bitmap import BitmapIndex

__all__ = ["BitmapIndex"]
