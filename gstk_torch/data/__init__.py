from gstk_torch.data.dataparser import (
    DataparserConfig,
    DataparserOutputs,
    parse_transforms,
)
from gstk_torch.data.datamanager import FullImageDatamanager

__all__ = [
    "DataparserConfig",
    "DataparserOutputs",
    "parse_transforms",
    "FullImageDatamanager",
]
