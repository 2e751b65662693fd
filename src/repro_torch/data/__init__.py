from .pipeline import DeviceFeeder, TokenBatcher, host_slice
from .synthetic import build_image_dataset, build_token_dataset

__all__ = ["DeviceFeeder", "TokenBatcher", "build_image_dataset",
           "build_token_dataset", "host_slice"]
